"""Forward NFT for the (quasi-)periodic NSE: main and auxiliary spectra.

Rebuild of fnft_nsep.c:82-864. The main spectrum consists of the
lambdas where the Floquet discriminant Delta(lam) = trace of the monodromy
matrix equals +-2 (more generally, the values in ``floquet_range`` scaled
by 2, which yields spines); the auxiliary spectrum are the roots of the
monodromy's upper-right entry.

Two localization strategies, mirroring the reference:

* GRIDSEARCH — evaluate the monodromy polynomial on unit-circle arcs with
  the chirp transform and locate real-line spectrum via the 3x3 minimum-
  modulus test (embarrassingly parallel).
* SUBSAMPLE_AND_REFINE — all-root localization (Ehrlich-Aberth on the
  subsampled monodromy polynomial, replacing the reference's Fortran
  companion QR) followed by a vectorized multiplicity-aware Newton
  refinement against the full-resolution monodromy.
* MIXED runs the second for the non-real spectrum and the first for the
  real line.

Quasi-periodic signals are handled by removing the phase rotation up front
and shifting the spectra back afterwards (reference :118-135, 200-213).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from fnft_tpu.config import complex_dtype_of, eps_of
from fnft_tpu.errors import check_arg
from fnft_tpu.models import nse
from fnft_tpu.models.discretization import (
    Discretization,
    degree,
    is_fast,
    upsampling_factor,
    z_to_lambda,
)
from fnft_tpu.ops.fscatter import fscatter
from fnft_tpu.ops.gridsearch import roots_fftgridsearch
from fnft_tpu.ops.roots import (certified_tol, poly_roots_batched,
                                root_residuals)
from fnft_tpu.ops.scatter import scatter_matrix
from fnft_tpu.utils import misc

OVERSAMPLING = 32  # grid points per polynomial degree (reference :43)


class Localization(enum.Enum):          # fnft_nsep.h:54-58
    SUBSAMPLE_AND_REFINE = "subsample_and_refine"
    GRIDSEARCH = "gridsearch"
    MIXED = "mixed"


class PointFilter(enum.Enum):           # fnft_nsep.h:70-74
    NONE = "none"
    MANUAL = "manual"
    AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class NsepOpts:
    """Defaults mirror fnft_nsep_default_opts (fnft_nsep.c:27-41)."""

    localization: Localization = Localization.MIXED
    filtering: PointFilter = PointFilter.AUTO
    bounding_box: tuple = (-np.inf, np.inf, -np.inf, np.inf)
    max_evals: int = 20
    discretization: Discretization = Discretization.SPLIT2A
    floquet_range: tuple = (-1.0, 1.0)
    points_per_spine: int = 2
    normalization_flag: bool = True
    dsub: int = 0
    tol: float = -1.0  # negative = auto (sqrt machine eps)


@dataclasses.dataclass
class NsepResult:
    main_spectrum: Optional[np.ndarray] = None
    aux_spectrum: Optional[np.ndarray] = None


def _auto_box(eps_t: float, map_coeff: float) -> tuple:
    """Resolvable region of the z-map (reference :837-864)."""
    re = 0.9 * math.pi / (abs(map_coeff) * eps_t)
    im = -math.log(0.1) / (abs(map_coeff) * eps_t)
    return (-re, re, -im, im)


def _filter_np(vals: np.ndarray, box) -> np.ndarray:
    m = ((np.real(vals) >= box[0]) & (np.real(vals) <= box[1])
         & (np.imag(vals) >= box[2]) & (np.imag(vals) <= box[3]))
    return vals[m]


def _monodromy_poly(tm11, tm_w):
    """p(z) ~ z^{deg/2} Delta(z): tm11 + conjugate-reversed tm11 (:319-320)."""
    return tm11 + jnp.conj(tm11[::-1])


def _gridsearch(q_pre, eps_t, kappa, box, opts, want_main, want_aux):
    disc = opts.discretization
    q_eff, r_eff, _, _ = nse.preprocess_signal(q_pre, eps_t, kappa, disc)
    tm, w = fscatter(q_eff, r_eff, eps_t, disc,
                     normalize=getattr(opts, 'normalization_flag', True),
                     want=((0, 0), (0, 1)), jsym=kappa)
    deg = tm.shape[-1] - 1
    map_coeff = 2.0 / degree(disc)
    if opts.filtering is PointFilter.AUTO:
        box = _auto_box(eps_t, map_coeff)
    phi = sorted((map_coeff * eps_t * box[0], map_coeff * eps_t * box[1]))
    if not np.isfinite(phi[0]) or not np.isfinite(phi[1]):
        phi = [0.0, 2.0 * math.pi]
    m_grid = OVERSAMPLING * deg

    def circle_roots(coeffs):
        roots_z, mask = roots_fftgridsearch(
            coeffs, phi0=float(phi[0]), phi1=float(phi[1]), m=m_grid)
        z = misc.compact_masked(roots_z, mask)
        lam = np.asarray(z_to_lambda(jnp.asarray(z), eps_t, disc)) \
            if z.size else np.zeros(0, complex)
        if opts.filtering is not PointFilter.NONE:
            lam = _filter_np(lam, box)
        return lam

    main = aux = None
    if want_main:
        p = _monodromy_poly(tm[0, 0], w)
        scale = 2.0 ** (-int(w))
        p_plus = p.at[deg // 2].add(2.0 * scale)
        p_minus = p.at[deg // 2].add(-2.0 * scale)
        main = np.concatenate([circle_roots(p_plus), circle_roots(p_minus)])
    if want_aux:
        aux = circle_roots(tm[0, 1])
    return main, aux, box


def _eval_floquet(q_eff, r_eff, lam, eps_t, base_disc):
    """(f, f') with f = Delta(lam) = T00 + T11 of the full monodromy."""
    t, td = scatter_matrix(q_eff, r_eff, jnp.asarray(lam), eps_t, base_disc,
                           derivative=True)
    return (t[:, 0, 0] + t[:, 1, 1]), (td[:, 0, 0] + td[:, 1, 1])


def _eval_b(q_eff, r_eff, lam, eps_t, base_disc):
    t, td = scatter_matrix(q_eff, r_eff, jnp.asarray(lam), eps_t, base_disc,
                           derivative=True)
    return t[:, 0, 1], td[:, 0, 1]


def _mainspec_newton_sweep(floquet, lam0, rhs, tol, iters):
    """The reference's higher-order-root Newton with m in {1,2} line
    search (refine_mainspec, :707-793) as one ``fori_loop``.

    Parameterized over the ``(f, f') = floquet(lam)`` evaluator so the
    single-device path (full scatter_matrix) and the D-sharded path
    (chunk products + all_gather, parallel/dshard_nsep.py) share one
    Newton body."""
    k = lam0.shape[0]
    # match the pipeline dtype: a float64 rhs would promote the c64 carry
    rhs = jnp.asarray(rhs).astype(jnp.real(lam0).dtype)
    rhs2 = jnp.concatenate([rhs, rhs]) if rhs.ndim == 1 else rhs
    f, fp = floquet(lam0)
    f = f + rhs

    def body(_, carry):
        lam, f, fp, frozen = carry
        fp_safe = jnp.where(fp == 0, 1.0, fp)
        incr = f / fp_safe
        cand = jnp.concatenate([lam - incr, lam - 2 * incr])
        fc, fpc = floquet(cand)
        fc = fc + rhs2
        f1, f2 = fc[:k], fc[k:]
        pick2 = jnp.abs(f2) < jnp.abs(f1)
        lam_new = jnp.where(pick2, lam - 2 * incr, lam - incr)
        f_new = jnp.where(pick2, f2, f1)
        fp_new = jnp.where(pick2, fpc[k:], fpc[:k])
        # converged states take a final plain Newton step and freeze (:781-788)
        conv = jnp.abs(f_new) < tol
        fp_new_safe = jnp.where(fp_new == 0, 1.0, fp_new)
        lam_final = jnp.where(conv, lam_new - f_new / fp_new_safe, lam_new)
        lam = jnp.where(frozen, lam, lam_final)
        f = jnp.where(frozen, f, f_new)
        fp = jnp.where(frozen, fp, fp_new)
        return lam, f, fp, frozen | conv | (fp_new == 0)

    frozen0 = jnp.zeros(k, dtype=bool)
    lam, _, _, _ = jax.lax.fori_loop(0, iters, body, (lam0, f, fp, frozen0))
    return lam


def _auxspec_newton_sweep(evalb, lam0, tol, iters):
    """Plain Newton on ``(f, f') = evalb(lam)`` with per-root freezing
    (refine_auxspec, :796-835); shared with parallel/dshard_nsep.py."""
    def body(_, carry):
        lam, frozen = carry
        f, fp = evalb(lam)
        fp_safe = jnp.where(fp == 0, 1.0, fp)
        lam_new = lam - f / fp_safe
        lam = jnp.where(frozen | (fp == 0), lam, lam_new)
        return lam, frozen | (jnp.abs(f) < tol) | (fp == 0)

    lam, _ = jax.lax.fori_loop(
        0, iters, body, (lam0, jnp.zeros(lam0.shape, dtype=bool)))
    return lam


@partial(jax.jit, static_argnames=("eps_t", "iters", "base_disc"))
def _refine_mainspec_loop(q_eff, r_eff, lam0, rhs, tol, eps_t, iters,
                          base_disc):
    """The whole mainspec Newton sweep as one XLA program (one dispatch
    instead of ``iters`` host round-trips)."""
    return _mainspec_newton_sweep(
        lambda lam: _eval_floquet(q_eff, r_eff, lam, eps_t, base_disc),
        lam0, rhs, tol, iters)


def _refine_mainspec(q_eff, r_eff, lam0, eps_t, rhs, tol, max_evals,
                     base_disc):
    """Vectorized higher-order-root Newton with m in {1,2} line search
    (reference refine_mainspec, :707-793)."""
    lam = np.asarray(lam0)
    if lam.size == 0 or max_evals == 0:
        return lam
    iters = max(1, (max_evals - 1) // 2)
    lam = _refine_mainspec_loop(q_eff, r_eff, jnp.asarray(lam),
                                jnp.asarray(rhs), jnp.asarray(tol),
                                float(eps_t), int(iters), base_disc)
    return np.asarray(lam)


@partial(jax.jit, static_argnames=("eps_t", "iters", "base_disc"))
def _refine_auxspec_loop(q_eff, r_eff, lam0, tol, eps_t, iters, base_disc):
    return _auxspec_newton_sweep(
        lambda lam: _eval_b(q_eff, r_eff, lam, eps_t, base_disc),
        lam0, tol, iters)


def _refine_auxspec(q_eff, r_eff, lam0, eps_t, tol, max_evals, base_disc):
    """Vectorized Newton on b(lam) (reference refine_auxspec, :796-835)."""
    lam = np.asarray(lam0)
    if lam.size == 0 or max_evals == 0:
        return lam
    lam = _refine_auxspec_loop(q_eff, r_eff, jnp.asarray(lam),
                               jnp.asarray(tol), float(eps_t),
                               int(max_evals), base_disc)
    return np.asarray(lam)


def _sr_localize(q_pre, eps_t, d, kappa, box, opts, want_main, want_aux,
                 skip_real):
    """Replicated S&R localization stage, shared by the single-device
    driver and parallel.dshard_nsep: subsampled fast monodromy, one
    batched Aberth dispatch over all spines + aux, per-spine candidate
    pre-filtering and aux backward-error certification.

    Returns ``(lam_cat, rhs_cat, aux_lam, ctx)`` where ``lam_cat``/
    ``rhs_cat`` are the main-spectrum Newton candidates with per-point
    spine values, ``aux_lam`` the certified aux candidates, and ``ctx``
    a dict with q_eff/r_eff/box/refine_tol/base/iters/post_filter.
    ``lam_cat``/``aux_lam`` are None when not wanted.
    """
    disc = opts.discretization
    q_eff, r_eff, _, _ = nse.preprocess_signal(q_pre, eps_t, kappa, disc)

    dsub = opts.dsub
    if dsub == 0:
        dsub = int(2.0 ** math.ceil(0.5 * math.log2(d * math.log2(d) ** 2)))
    else:
        dsub = int(2.0 ** round(math.log2(dsub)))
    qs_eff, rs_eff, dsub_act, _ = nse.preprocess_signal(
        q_pre, eps_t, kappa, disc, dsub)
    nskip = d // dsub_act
    eps_t_sub = nskip * eps_t

    tm, w = fscatter(qs_eff, rs_eff, eps_t_sub, disc,
                     normalize=getattr(opts, 'normalization_flag', True),
                     want=((0, 0), (0, 1)), jsym=kappa)
    deg = tm.shape[-1] - 1
    map_coeff = 2.0 / degree(disc)
    if opts.filtering is PointFilter.AUTO:
        box = _auto_box(eps_t_sub, map_coeff)
    tol_im = (box[1] - box[0]) / (OVERSAMPLING * (d - 1))
    cdt = complex_dtype_of(q_pre)
    refine_tol = math.sqrt(eps_of(cdt)) if opts.tol < 0 else opts.tol
    base = nse.newton_base_discretization(disc)
    assert q_eff.shape[-1] == d * upsampling_factor(disc)

    def post_filter(lam):
        if opts.filtering is not PointFilter.NONE:
            lam = _filter_np(lam, box)
        if skip_real:
            lam = lam[np.abs(np.imag(lam)) > tol_im]
        return lam

    # All root solves (every spine value + the aux polynomial) share one
    # batched Aberth dispatch: the reference calls eiscor once per spine
    # (fnft_nsep.c:556-608); a per-call host round-trip would stall a device
    # pipeline, so the per-spine polynomials are stacked instead.
    rhs_vals = np.zeros(0)
    polys = []
    if want_main:
        p = _monodromy_poly(tm[0, 0], w)
        center = p[deg // 2]
        scale = 2.0 ** (-int(w))
        rhs0, rhs1 = opts.floquet_range
        nvals = opts.points_per_spine
        step = (rhs1 - rhs0) / (nvals - 1) if nvals > 1 else 0.0
        rhs_vals = 2.0 * (rhs0 + step * np.arange(nvals))
        p_all = jnp.tile(p[None, :], (nvals, 1))
        p_all = p_all.at[:, deg // 2].set(
            center - jnp.asarray(rhs_vals).astype(p.dtype) * scale)
        polys.append(p_all)
    if want_aux:
        polys.append(tm[0, 1][None, :])
    ctx = dict(q_eff=q_eff, r_eff=r_eff, box=box, refine_tol=refine_tol,
               base=base, max_evals=opts.max_evals, post_filter=post_filter)
    if not polys:  # e.g. MIXED with kappa=-1 and want_aux=False
        return None, None, None, ctx
    roots_all = poly_roots_batched(jnp.concatenate(polys, axis=0))
    lam_all = np.asarray(
        z_to_lambda(roots_all.reshape(-1), eps_t_sub, disc)
    ).reshape(roots_all.shape)

    lam_cat = rhs_cat = aux_lam = None
    if want_main:
        nvals = len(rhs_vals)
        # pre-filter each spine's roots; every survivor goes into one
        # vectorized Newton call with a per-point rhs
        lam_parts, rhs_parts = [], []
        for nval in range(nvals):
            lam = post_filter(lam_all[nval])
            lam_parts.append(lam)
            rhs_parts.append(np.full(lam.shape, -rhs_vals[nval]))
        lam_cat = np.concatenate(lam_parts) if lam_parts else np.zeros(0, complex)
        rhs_cat = np.concatenate(rhs_parts) if rhs_parts else np.zeros(0)
    if want_aux:
        # per-root backward-error certificate: uncertified Aberth outputs
        # (eta > O(deg*eps)) are spurious — unlike the main spectrum, the
        # aux path has no spine cross-check, so drop them before Newton
        eta = np.asarray(root_residuals(tm[0, 1], roots_all[-1]))
        aux_lam = lam_all[-1][eta <= certified_tol(deg, cdt)]
        if opts.filtering is not PointFilter.NONE:
            aux_lam = _filter_np(aux_lam, box)
    return lam_cat, rhs_cat, aux_lam, ctx


def _subsample_and_refine(q_pre, eps_t, d, kappa, box, opts, want_main,
                          want_aux, skip_real):
    lam_cat, rhs_cat, aux_lam, ctx = _sr_localize(
        q_pre, eps_t, d, kappa, box, opts, want_main, want_aux, skip_real)
    q_eff, r_eff = ctx["q_eff"], ctx["r_eff"]
    post_filter = ctx["post_filter"]
    main = aux = None
    if lam_cat is not None:
        lam_ref = _refine_mainspec(q_eff, r_eff, lam_cat, eps_t,
                                   jnp.asarray(rhs_cat), ctx["refine_tol"],
                                   ctx["max_evals"], ctx["base"])
        main = post_filter(lam_ref)
    if aux_lam is not None:
        lam = _refine_auxspec(q_eff, r_eff, aux_lam, eps_t,
                              ctx["refine_tol"], ctx["max_evals"],
                              ctx["base"])
        aux = post_filter(lam)
    return main, aux, ctx["box"]


def nsep(q, t_span, *, kappa: int = +1, phase_shift: float = 0.0,
         want_main: bool = True, want_aux: bool = True,
         opts: NsepOpts | None = None) -> NsepResult:
    """Main/auxiliary spectrum of a (quasi-)periodic signal.

    Args:
      q: samples on t_n = T0 + n*(T1-T0)/D, n = 0..D-1 (period T1-T0;
        the last sample is *before* T1). D must be a power of two.
      t_span: (T0, T1) — one period.
      kappa: +1 focusing / -1 defocusing.
      phase_shift: for quasi-periodic signals, arg(q(t+L)/q(t)).
    """
    opts = opts or NsepOpts()
    q = jnp.asarray(q)
    d = q.shape[-1]
    check_arg(d >= 2 and (d & (d - 1)) == 0, "D must be a power of two")
    t0, t1 = float(t_span[0]), float(t_span[1])
    check_arg(t0 < t1, "T[0] < T[1] required")
    check_arg(kappa in (-1, 1), "kappa must be +-1")
    check_arg(is_fast(opts.discretization),
              "nsep requires a fast (polynomial) discretization")

    eps_t = (t1 - t0) / d
    lam_shift = phase_shift / (-2.0 * (t1 - t0))
    rdt = jnp.real(q).dtype
    tgrid = t0 + eps_t * jnp.arange(d, dtype=rdt)
    q_pre = q * jnp.exp(2j * lam_shift * tgrid)

    box = list(opts.bounding_box)
    if opts.filtering is PointFilter.MANUAL:
        box[0] -= lam_shift
        box[1] -= lam_shift
    box = tuple(box)

    main = aux = None
    if opts.localization is Localization.MIXED:
        m1, a1, _ = _subsample_and_refine(
            q_pre, eps_t, d, kappa, box, opts,
            want_main and kappa == +1, want_aux, skip_real=True)
        m2, a2, _ = _gridsearch(q_pre, eps_t, kappa, box, opts, want_main,
                                want_aux)
        main = np.concatenate([x for x in (m1, m2) if x is not None]) \
            if want_main else None
        aux = np.concatenate([x for x in (a1, a2) if x is not None]) \
            if want_aux else None
    elif opts.localization is Localization.SUBSAMPLE_AND_REFINE:
        main, aux, _ = _subsample_and_refine(q_pre, eps_t, d, kappa, box,
                                             opts, want_main, want_aux,
                                             skip_real=False)
    elif opts.localization is Localization.GRIDSEARCH:
        main, aux, _ = _gridsearch(q_pre, eps_t, kappa, box, opts,
                                   want_main, want_aux)
    else:
        raise ValueError(opts.localization)

    if main is not None:
        main = main + lam_shift
    if aux is not None:
        aux = aux + lam_shift
    return NsepResult(main_spectrum=main, aux_spectrum=aux)
