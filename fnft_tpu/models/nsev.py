"""Forward NFT for the nonlinear Schroedinger equation, vanishing BCs.

Rebuild of fnft_nsev.c. The driver is host-orchestrated Python that
composes jitted kernels (fscatter tree, chirp-Z, Aberth rootfinder, Newton
scans); array shapes stay static inside every kernel, and dynamic-length
results (bound states) are compacted once at the API boundary.

Pipeline (fast discretizations, mirrors fnft_nsev.c:133-453):

  preprocess -> fscatter (FFT tree) -> contspec via chirp-Z + phase factors
             -> bound states: subsample fscatter -> Aberth roots of a(z)
                -> filter/merge -> vectorized Newton refinement (full D)
             -> norming constants / residues via phi/psi dual sweeps
             -> optional Richardson extrapolation against a half-D pass
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
from fnft_tpu.errors import check_arg, warn
from fnft_tpu.models import nse
from fnft_tpu.models.discretization import (
    Discretization,
    degree,
    is_fast,
    lambda_to_z,
    upsampling_factor,
    z_to_lambda,
)
from fnft_tpu.ops.fscatter import fscatter
from fnft_tpu.ops.poly import chirpz
from fnft_tpu.ops.roots import poly_roots
from fnft_tpu.ops.scatter import scatter_bound_states, scatter_matrix
from fnft_tpu.utils import misc


class BoundStateFilter(enum.Enum):      # fnft_nsev.h:51-55
    NONE = "none"
    BASIC = "basic"
    FULL = "full"


class BoundStateLocalization(enum.Enum):  # fnft_nsev.h:91-95
    FAST_EIGENVALUE = "fast_eigenvalue"
    NEWTON = "newton"
    SUBSAMPLE_AND_REFINE = "subsample_and_refine"


class DiscspecType(enum.Enum):          # fnft_nsev.h:108-112
    NORMING_CONSTANTS = "norming_constants"
    RESIDUES = "residues"
    BOTH = "both"


class ContspecType(enum.Enum):          # fnft_nsev.h:130-134
    REFLECTION_COEFFICIENT = "reflection_coefficient"
    AB = "ab"
    BOTH = "both"


@dataclasses.dataclass(frozen=True)
class NsevOpts:
    """Options (defaults mirror fnft_nsev_default_opts, fnft_nsev.c:26-36)."""

    bound_state_filtering: BoundStateFilter = BoundStateFilter.FULL
    bound_state_localization: BoundStateLocalization = (
        BoundStateLocalization.SUBSAMPLE_AND_REFINE)
    niter: int = 10
    dsub: int = 0  # 0 = auto
    discspec_type: DiscspecType = DiscspecType.NORMING_CONSTANTS
    contspec_type: ContspecType = ContspecType.REFLECTION_COEFFICIENT
    normalization_flag: bool = True
    discretization: Discretization = Discretization.SPLIT4B
    richardson_extrapolation: bool = False


@dataclasses.dataclass
class NsevResult:
    reflection_coefficient: Optional[jnp.ndarray] = None
    a: Optional[jnp.ndarray] = None
    b: Optional[jnp.ndarray] = None
    bound_states: Optional[np.ndarray] = None
    norming_constants: Optional[np.ndarray] = None
    residues: Optional[np.ndarray] = None


def nsev_max_k(d: int, opts: NsevOpts | None = None) -> int:
    """Maximum number of detectable bound states (fnft_nsev_max_K, :51-57)."""
    opts = opts or NsevOpts()
    return degree(opts.discretization) * d


def _re_bound(eps_t: float, map_coeff: float) -> float:
    """Resolvable real-part range (fnft_nsev.c:569-578)."""
    return 0.9 * math.pi / abs(map_coeff * eps_t)


def _im_bound(q, t0: float, t1: float) -> float:
    """Parseval-based bound on bound-state imaginary parts (:582-592)."""
    return float(1.5 * 0.25 * misc.l2norm2(q, t0, t1))


def _contspec_eval(tm, w, q_eff, r_eff, eps_t, t0, t1, d_given, xi0, xi1, m,
                   disc):
    """H11(xi), H21(xi) on the xi grid (fnft_nsev.c:744-835)."""
    if degree(disc) > 0:
        deg1 = 2.0 / nse.xi_map_coeff(disc)  # = degree * upsampling
        eps_xi = (xi1 - xi0) / (m - 1)
        a_pt = complex(np.exp(2j * xi0 * eps_t / deg1))
        w_pt = complex(np.exp(2j * eps_xi * eps_t / deg1))
        h11 = chirpz(tm[0, 0], a_pt, w_pt, m)
        h21 = chirpz(tm[1, 0], a_pt, w_pt, m)
        return h11, h21, w
    xi = jnp.linspace(xi0, xi1, m)
    t = scatter_matrix(q_eff, r_eff, xi, eps_t, disc)
    return t[:, 0, 0], t[:, 1, 0], jnp.zeros((), jnp.int32)


def _apply_phase_factors(h11, h21, w, eps_t, t0, t1, d_given, xi0, xi1, m,
                         kappa, disc, contspec_type):
    rdt = jnp.real(h11).dtype
    xi = jnp.linspace(jnp.asarray(xi0, rdt), jnp.asarray(xi1, rdt), m)
    out = {}
    if contspec_type in (ContspecType.REFLECTION_COEFFICIENT, ContspecType.BOTH):
        pf = nse.phase_factor_rho(eps_t, t1, disc)
        out["rho"] = h21 * jnp.exp(1j * xi * pf) / h11
    if contspec_type in (ContspecType.AB, ContspecType.BOTH):
        # ldexp, not exp2: exact 2^w (XLA:CPU exp2 errs ~1e-6 in f32)
        scale = jnp.ldexp(jnp.asarray(1.0, rdt), w)
        pfa = nse.phase_factor_a(eps_t, d_given, t0, t1, disc)
        pfb = nse.phase_factor_b(eps_t, d_given, t0, t1, disc)
        out["a"] = h11 * scale * jnp.exp(1j * xi * pfa)
        out["b"] = h21 * scale * jnp.exp(1j * xi * pfb)
    return out


@partial(jax.jit, static_argnames=("disc", "niter", "eps_t", "t0", "t1"))
def _newton_refine_loop(q_eff, r_eff, lam0, box, eps_t, t0, t1, disc, niter):
    """One XLA program for the whole ``niter`` Newton sweep (single
    dispatch instead of niter host round-trips)."""
    eprec = 100.0 * eps_of(lam0.dtype)

    def body(_, carry):
        lam, active = carry
        a, ap, _ = scatter_bound_states(q_eff, r_eff, lam, eps_t, t0, t1,
                                        disc, skip_b=True)
        step = a / jnp.where(ap == 0, 1.0, ap)
        step = jnp.where((a == 0) | (ap == 0), 0.0, step)
        lam_new = jnp.where(active, lam - step, lam)
        in_box = ((jnp.real(lam_new) >= box[0])
                  & (jnp.real(lam_new) <= box[1])
                  & (jnp.imag(lam_new) >= box[2])
                  & (jnp.imag(lam_new) <= box[3]))
        active = active & (jnp.abs(step) > eprec) & in_box
        return lam_new, active

    lam, _ = jax.lax.fori_loop(
        0, niter, body, (lam0, jnp.ones(lam0.shape, dtype=bool)))
    return lam


def _newton_refine(q_eff, r_eff, lam0, eps_t, t0, t1, disc, niter,
                   bounding_box):
    """Vectorized Newton iteration on a(lam) (fnft_nsev.c:973-1038).

    All states iterate together; a state freezes once its update is below
    100*eps, it hits a(lam)=0, or it leaves the bounding box.
    """
    lam = jnp.asarray(lam0)
    if lam.size == 0:
        return lam
    box = jnp.asarray(np.asarray(bounding_box, dtype=np.float64))
    return _newton_refine_loop(q_eff, r_eff, lam, box, float(eps_t),
                               float(t0), float(t1), disc, int(niter))


def _compute_boundstates(q_eff, r_eff, q_orig, tm11, w, eps_t, t0, t1,
                         disc, opts, bsloc, initial_states, kappa):
    """Bound-state localization + filtering (fnft_nsev.c:595-741)."""
    deg1 = max(degree(disc), 1)
    map_coeff = 2.0 / deg1 if degree(disc) > 0 else 2.0
    if opts.bound_state_filtering is BoundStateFilter.FULL:
        box = (-_re_bound(eps_t, map_coeff), _re_bound(eps_t, map_coeff),
               0.0, _im_bound(q_orig, t0, t1))
    elif opts.bound_state_filtering is BoundStateFilter.BASIC:
        box = (-np.inf, np.inf, 0.0, np.inf)
    else:
        box = (-np.inf, np.inf, -np.inf, np.inf)

    if bsloc is BoundStateLocalization.FAST_EIGENVALUE:
        roots_z = poly_roots(tm11)
        lam = z_to_lambda(roots_z, eps_t, disc)
    elif bsloc is BoundStateLocalization.NEWTON:
        base = nse.newton_base_discretization(disc)
        lam = _newton_refine(q_eff, r_eff, jnp.asarray(initial_states),
                             eps_t, t0, t1, base, opts.niter, box)
    else:
        raise ValueError(bsloc)

    if opts.bound_state_filtering is not BoundStateFilter.NONE:
        # filter + dedupe on device (merge_mask chunks its distance matrix
        # above 2048 points), then a single host compaction at the boundary
        mask = misc.filter_mask(lam, box)
        mask = misc.merge_mask(lam, misc.merge_tol_default(np.complex128),
                               mask)
        lam = misc.compact_masked(lam, mask)
    else:
        lam = np.asarray(lam)
    return lam


def _compute_normconsts_or_residues(q_eff, r_eff, lam, eps_t, t0, t1, disc,
                                    discspec_type):
    """(normconsts, residues) at bound states (fnft_nsev.c:895-970)."""
    base = nse.newton_base_discretization(disc)
    a, ap, b = scatter_bound_states(q_eff, r_eff, jnp.asarray(lam), eps_t,
                                    t0, t1, base, skip_b=False)
    norm = np.asarray(b)
    res = np.asarray(b / ap)
    aprime = np.asarray(ap)
    return norm, res, aprime


def _nsev_base(q_eff, r_eff, q_orig, t0, t1, m, xi0, xi1, kappa, opts,
               bsloc, initial_states, want_contspec, want_dspec):
    """One full pass at a fixed resolution (fnft_nsev_base, :458-565)."""
    disc = opts.discretization
    ups = upsampling_factor(disc)
    d_eff = q_eff.shape[-1]
    d_given = d_eff // ups
    eps_t = (t1 - t0) / (d_given - 1)

    tm, w = (None, jnp.zeros((), jnp.int32))
    if is_fast(disc):
        tm, w = fscatter(q_eff, r_eff, eps_t, disc,
                         normalize=opts.normalization_flag,
                         want=((0, 0), (1, 0)), jsym=kappa)

    result = NsevResult()
    if want_contspec and m > 0:
        h11, h21, w_ = _contspec_eval(tm, w, q_eff, r_eff, eps_t, t0, t1,
                                      d_given, xi0, xi1, m, disc)
        cs = _apply_phase_factors(h11, h21, w_, eps_t, t0, t1, d_given,
                                  xi0, xi1, m, kappa, disc,
                                  opts.contspec_type)
        result.reflection_coefficient = cs.get("rho")
        result.a = cs.get("a")
        result.b = cs.get("b")

    if kappa == +1 and want_dspec:
        tm11 = tm[0, 0] if tm is not None else None
        lam = _compute_boundstates(q_eff, r_eff, q_orig, tm11, w, eps_t,
                                   t0, t1, disc, opts, bsloc,
                                   initial_states, kappa)
        result.bound_states = lam
        if lam.size > 0:
            norm, res, _ = _compute_normconsts_or_residues(
                q_eff, r_eff, lam, eps_t, t0, t1, disc, opts.discspec_type)
            result.norming_constants = norm
            result.residues = res
    return result


def nsev(q, t_span, *, m: int = 0, xi_span=None, kappa: int = +1,
         opts: NsevOpts | None = None,
         want_bound_states: bool = True) -> NsevResult:
    """Fast forward NFT of the vanishing-BC NSE (reference fnft_nsev.c:133).

    Args:
      q: complex signal samples ``[D]`` on the grid t_n = T0 + n eps_t.
      t_span: (T0, T1).
      m: number of continuous-spectrum points (0 = skip contspec).
      xi_span: (XI0, XI1) spectral grid bounds (required when m > 0).
      kappa: +1 focusing, -1 defocusing.
      opts: :class:`NsevOpts`.
      want_bound_states: compute the discrete spectrum (kappa=+1 only).

    Returns :class:`NsevResult` with requested fields populated.
    """
    opts = opts or NsevOpts()
    q = jnp.asarray(q)
    d = q.shape[-1]
    t0, t1 = float(t_span[0]), float(t_span[1])
    check_arg(d >= 2, "D must be >= 2")
    check_arg(t0 < t1, "T[0] < T[1] required")
    check_arg(kappa in (-1, 1), "kappa must be +-1")
    if m > 0:
        check_arg(xi_span is not None and float(xi_span[0]) < float(xi_span[1]),
                  "valid XI required for continuous spectrum")
    xi0, xi1 = (float(xi_span[0]), float(xi_span[1])) if xi_span else (0.0, 0.0)
    disc = opts.discretization
    if not is_fast(disc) and kappa == +1 and want_bound_states:
        check_arg(opts.bound_state_localization is BoundStateLocalization.NEWTON,
                  "slow discretizations support only NEWTON localization")

    eps_t = (t1 - t0) / (d - 1)
    q_eff, r_eff, _, _ = nse.preprocess_signal(q, eps_t, kappa, disc)

    want_dspec = want_bound_states and kappa == +1
    bsloc = opts.bound_state_localization

    if (want_dspec and bsloc is BoundStateLocalization.SUBSAMPLE_AND_REFINE
            and is_fast(disc)):
        # two-pass method: subsampled fast eigenvalues, full-D Newton
        dsub = opts.dsub or int(math.sqrt(d * math.log2(d) ** 2))
        qs_eff, rs_eff, dsub_act, (i0, i1) = nse.preprocess_signal(
            q, eps_t, kappa, disc, dsub)
        ts0, ts1 = t0 + i0 * eps_t, t0 + i1 * eps_t
        sub = _nsev_base(qs_eff, rs_eff, q, ts0, ts1, 0, xi0, xi1, kappa,
                         opts, BoundStateLocalization.FAST_EIGENVALUE, None,
                         False, True)
        result = _nsev_base(q_eff, r_eff, q, t0, t1, m, xi0, xi1, kappa,
                            opts, BoundStateLocalization.NEWTON,
                            sub.bound_states, m > 0, True)
    else:
        init = None
        if bsloc is BoundStateLocalization.NEWTON:
            init = getattr(opts, "initial_bound_states", None)
            if init is None:
                raise ValueError(
                    "NEWTON localization needs initial bound states; use "
                    "nsev_with_initial_states or SUBSAMPLE_AND_REFINE")
        result = _nsev_base(q_eff, r_eff, q, t0, t1, m, xi0, xi1, kappa,
                            opts, bsloc, init, m > 0, want_dspec)

    if opts.richardson_extrapolation:
        result = _richardson(result, q, t0, t1, m, xi0, xi1, kappa, opts,
                             want_dspec)
    return result


def nsev_with_initial_states(q, t_span, initial_states, *, m: int = 0,
                             xi_span=None, kappa: int = +1,
                             opts: NsevOpts | None = None) -> NsevResult:
    """NEWTON-localized nsev with user-supplied initial bound states."""
    opts = opts or NsevOpts()
    opts = dataclasses.replace(
        opts, bound_state_localization=BoundStateLocalization.NEWTON)
    object.__setattr__(opts, "initial_bound_states", np.asarray(initial_states))
    return nsev(q, t_span, m=m, xi_span=xi_span, kappa=kappa, opts=opts)


def _richardson(result, q, t0, t1, m, xi0, xi1, kappa, opts, want_dspec):
    """Richardson extrapolation against a half-resolution pass
    (fnft_nsev.c:316-442)."""
    from fnft_tpu.models.discretization import method_order

    d = q.shape[-1]
    eps_t = (t1 - t0) / (d - 1)
    dsub = (d + 1) // 2
    qs_eff, rs_eff, dsub_act, (i0, i1) = nse.preprocess_signal(
        q, eps_t, kappa, opts.discretization, dsub)
    ts0, ts1 = t0 + i0 * eps_t, t0 + i1 * eps_t
    eps_t_sub = (ts1 - ts0) / (dsub_act - 1)

    init = result.bound_states if want_dspec else None
    sub = _nsev_base(qs_eff, rs_eff, q, ts0, ts1, m, xi0, xi1, kappa, opts,
                     BoundStateLocalization.NEWTON, init, m > 0, want_dspec
                     and init is not None and init.size > 0)

    order = method_order(opts.discretization)
    scl_num = (eps_t_sub / eps_t) ** order
    scl_den = scl_num - 1.0

    def rich(full, half):
        return (scl_num * full - half) / scl_den

    if m > 0:
        xi = np.linspace(xi0, xi1, m)
        ok = np.abs(xi) < 0.9 * np.pi / (2.0 * eps_t_sub)
        for field in ("reflection_coefficient", "a", "b"):
            full = getattr(result, field)
            half = getattr(sub, field)
            if full is not None and half is not None:
                setattr(result, field,
                        jnp.where(jnp.asarray(ok), rich(full, half), full))

    if want_dspec and result.bound_states is not None \
            and result.bound_states.size > 0 and sub.bound_states is not None \
            and sub.bound_states.size > 0:
        full_bs = np.asarray(result.bound_states)
        half_bs = np.asarray(sub.bound_states)
        # match each full-resolution state to its nearest half-res partner
        dist = np.abs(full_bs[:, None] - half_bs[None, :]) / \
            np.abs(full_bs)[:, None]
        loc = np.argmin(dist, axis=1)
        ok = dist[np.arange(len(full_bs)), loc] < eps_t
        merged = np.where(ok, rich(full_bs, half_bs[loc]), full_bs)
        result.bound_states = merged
        if result.residues is not None and sub.residues is not None:
            # Richardson on a' (= b/res), then recombine (reference :426-434)
            ap_full = result.norming_constants / result.residues
            ap_half = sub.norming_constants[loc] / sub.residues[loc]
            ap = np.where(ok, rich(ap_full, ap_half), ap_full)
            result.residues = result.norming_constants / ap
    return result
