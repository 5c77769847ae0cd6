"""Full-spectrum (contspec + discrete spectrum) nsev for complex-free devices.

Composes the real-pair and df64 lowerings into the complete flagship
driver of the reference (fnft_nsev.c:133-453) executable on a backend
with no complex types and no FFT HLO:

  contspec        rho_pipeline_df64_tabled   (reference tolerance, df64)
  localization    rc SPLIT4B tree on the subsampled signal
                  -> real-pair Ehrlich-Aberth (ops/tpu_roots.py), f32
  filtering       host box + merge  (fnft_nsev.c:569-741 semantics)
  refinement      df64 Newton on a(lam), BO base scheme
                  (ops/df64_boundstates.newton_refine_df64)
  discrete spec   df64 phi/psi sweeps -> b, a' -> norming consts/residues
                  (ops/df64_boundstates.ab_at_states_df64)

The subsample rule Dsub = sqrt(D log2^2 D) (fnft_nsev.c:283-286) is
rounded to a power of two so the rc tree and the matmul FFTs stay on exact
power-of-two grids.
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from fnft_tpu.ops import tables
from fnft_tpu.ops.tpu_pipeline import _split4b_column, _tree_column_rc
from fnft_tpu.ops.tpu_roots import poly_roots_rc


def subsample_plan(d: int, dsub_hint: int = 0) -> tuple[int, int]:
    """(dsub, stride): power-of-two subsampling near sqrt(D log2^2 D)."""
    if d & (d - 1):
        raise ValueError("D must be a power of two")
    target = dsub_hint or math.sqrt(d * max(math.log2(d), 1.0) ** 2)
    dsub = 1
    while dsub * 2 <= d and dsub * 2 <= target:
        dsub *= 2
    # round to the NEAREST power of two (not floor): the subsample stage
    # only seeds Newton, but a better seed costs little
    if dsub * 2 <= d and (target / dsub) > (dsub * 2) / target:
        dsub *= 2
    return dsub, d // dsub


def boundstate_init_pipeline(dsub: int, eps_sub: float, *, kappa: int = 1,
                             num_iters: int = 60):
    """Jitted (q_re, q_im) [dsub] -> (roots_re, roots_im) [2*dsub].

    SPLIT4B transfer polynomial P11 via the rc J-symmetric value tree,
    then Newton-polygon + Aberth sweeps, all on device in f32 pairs.
    Memoized per geometry: rebuilding re-traces the rc tree.
    """
    return _boundstate_init_cached(dsub, float(eps_sub), kappa, num_iters)


@lru_cache(maxsize=32)
def _boundstate_init_cached(dsub: int, eps_sub: float, kappa: int,
                            num_iters: int):
    def fn(q_re, q_im):
        col = _split4b_column((q_re, q_im), eps_sub, kappa)
        rows = _tree_column_rc(col, kappa)
        a_poly = (rows[0][..., 0, :], rows[1][..., 0, :])
        return poly_roots_rc(a_poly, num_iters=num_iters)

    ex = (jax.ShapeDtypeStruct((dsub,), jnp.float32),) * 2
    return tables.jit_tabled(fn, ex)


def _l2norm2_host(q128: np.ndarray, t0: float, t1: float) -> float:
    """Trapezoid-weighted ||q||_2^2 on the host (utils/misc.l2norm2 math;
    no complex array may touch the device on this backend)."""
    n = q128.shape[-1]
    w = np.ones(n)
    w[0] = w[-1] = 0.5
    return float((t1 - t0) / n * np.sum(w * np.abs(q128) ** 2))


def _filter_merge_host(lam: np.ndarray, box, merge_tol: float) -> np.ndarray:
    """Box filter + pairwise merge on the host (fnft_nsev.c:697-741)."""
    keep = ((lam.real >= box[0]) & (lam.real <= box[1])
            & (lam.imag >= box[2]) & (lam.imag <= box[3])
            & np.isfinite(lam))
    lam = lam[keep]
    if lam.size == 0:
        return lam
    order = np.argsort(-lam.imag)   # strongest (deepest) states first
    lam = lam[order]
    out: list[complex] = []
    for v in lam:
        if all(abs(v - u) > merge_tol for u in out):
            out.append(v)
    return np.asarray(out, np.complex128)


def locate_boundstates_tpu(q128, t_span, *, dsub_hint: int = 0,
                           num_iters: int = 60):
    """Bound-state candidates from the on-device subsample stage.

    Returns filtered host complex128 candidates (possibly empty). The
    filter box mirrors models/nsev._compute_boundstates with FULL
    filtering (fnft_nsev.c:569-592): resolvable real parts at the
    SUBSAMPLED step and the Parseval imaginary bound of the full signal.
    """
    q128 = np.asarray(q128, np.complex128)
    d = q128.shape[-1]
    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / (d - 1)
    dsub, stride = subsample_plan(d, dsub_hint)
    eps_sub = eps_t * stride
    qs = q128[::stride]

    fn = boundstate_init_pipeline(dsub, eps_sub, num_iters=num_iters)
    args = (jnp.asarray(qs.real.astype(np.float32)),
            jnp.asarray(qs.imag.astype(np.float32)))
    zr, zi = fn(*args)
    z = np.asarray(zr, np.float64) + 1j * np.asarray(zi, np.float64)
    # z = exp(2 i lam eps_sub / deg1), deg1 = 2 for SPLIT4B
    with np.errstate(divide="ignore", invalid="ignore"):
        lam = np.log(z) / (1j * eps_sub)
    # FULL filtering box: map_coeff = 2/deg1 = 1 at the subsampled step
    re_bound = 0.9 * math.pi / eps_sub
    im_bound = 1.5 * 0.25 * _l2norm2_host(q128, t0, t1)
    box = (-re_bound, re_bound, 1e-7, im_bound)
    return _filter_merge_host(lam, box, float(np.sqrt(np.finfo(np.float64).eps)))


def nsev_fullspec_df64(q128, t_span, *, m: int = 0, xi_span=None,
                       dsub_hint: int = 0, niter: int = 10,
                       contspec_fn=None):
    """Complete nsev (rho + bound states + norming constants + residues)
    with every device op complex-free f32 (rc / df64 tiers).

    Returns a dict with keys rho (complex128 [M] or None), bound_states,
    norming_constants, residues, a_prime (complex128 [K]).
    """
    from fnft_tpu.ops.df64_boundstates import (ab_at_states_df64,
                                               newton_refine_df64)
    from fnft_tpu.ops.df64_pipeline import rho_pipeline_df64_tabled

    q128 = np.asarray(q128, np.complex128)
    d = q128.shape[-1]
    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / (d - 1)

    rho = None
    if m > 0:
        if xi_span is None:
            raise ValueError("xi_span required when m > 0")
        if contspec_fn is None and jax.default_backend() == "cpu":
            # the tabled (one-program) pipeline's deep df64 chains cannot
            # compile on XLA:CPU; use the eager-staged CPU API instead
            from fnft_tpu.ops.df64_pipeline import nsev_contspec_df64

            rho = nsev_contspec_df64(q128, d=d, m=m, t_span=(t0, t1),
                                     xi_span=(float(xi_span[0]),
                                              float(xi_span[1])))
        else:
            fn = contspec_fn or rho_pipeline_df64_tabled(
                d, m, (t0, t1), (float(xi_span[0]), float(xi_span[1])))
            re, im_ = np.real(q128), np.imag(q128)
            rh = re.astype(np.float32)
            rl = (re - rh.astype(np.float64)).astype(np.float32)
            ih = im_.astype(np.float32)
            il = (im_ - ih.astype(np.float64)).astype(np.float32)
            out = fn(*(jnp.asarray(x) for x in (rh, rl, ih, il)))
            rho = (np.asarray(out[0], np.float64)
                   + np.asarray(out[1], np.float64)
                   + 1j * (np.asarray(out[2], np.float64)
                           + np.asarray(out[3], np.float64)))

    cand = locate_boundstates_tpu(q128, (t0, t1), dsub_hint=dsub_hint)
    if cand.size == 0:
        return dict(rho=rho, bound_states=cand,
                    norming_constants=np.empty(0, np.complex128),
                    residues=np.empty(0, np.complex128),
                    a_prime=np.empty(0, np.complex128))

    # pad to a power-of-two K by repeating the last candidate (duplicate
    # lanes converge to duplicate roots and are merged below; repetition
    # keeps every lane numerically benign, unlike out-of-box sentinels)
    k = cand.size
    k_pad = 1 << max(0, (k - 1)).bit_length()
    lam0 = np.concatenate([cand, np.full(k_pad - k, cand[-1])])

    re_bound = 0.9 * math.pi / eps_t
    im_bound = 1.5 * 0.25 * _l2norm2_host(q128, t0, t1)
    box = (-re_bound, re_bound, 0.0, im_bound)
    lam = newton_refine_df64(q128, lam0, (t0, t1), niter=niter,
                             bounding_box=box)
    lam = _filter_merge_host(lam[:k], box,
                             float(np.sqrt(np.finfo(np.float64).eps)))
    if lam.size == 0:
        return dict(rho=rho, bound_states=lam,
                    norming_constants=np.empty(0, np.complex128),
                    residues=np.empty(0, np.complex128),
                    a_prime=np.empty(0, np.complex128))
    _a, aprime, b = ab_at_states_df64(q128, lam, (t0, t1))
    return dict(rho=rho, bound_states=lam, norming_constants=b,
                residues=b / aprime, a_prime=aprime)
