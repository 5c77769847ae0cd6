"""NSE equation adapter: signal preprocessing and boundary phase factors.

Rebuild of fnft__nse_discretization.c (r-potential construction,
commutator-free stage resampling, ES4/TES4 derivative slots, phase factors)
and fnft__nse_fscatter.c / fnft__nse_scatter_matrix.c (thin r-builders).

The NSE maps onto the AKNS system with r = -kappa * conj(q)
(fnft__nse_fscatter.c:77-84).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from fnft_tpu.config import complex_dtype_of
from fnft_tpu.errors import check_arg
from fnft_tpu.models.discretization import (
    BOUNDARY_COEFF,
    Discretization,
    degree,
    degree1step_total,
    method_weights,
    upsampling_factor,
)
from fnft_tpu.utils.misc import downsample_indices, resample


def preprocess_signal(q, eps_t: float, kappa: int, disc: Discretization,
                      dsub: int | None = None):
    """Resample/subsample a signal as required by the discretization.

    Returns (q_eff, r_eff, dsub_actual, (first_index, last_index)) where
    the effective arrays have ``dsub_actual * upsampling_factor`` samples.
    Mirrors fnft__nse_discretization.c:386-656.
    """
    q = jnp.asarray(q)
    cdt = complex_dtype_of(q)
    q = q.astype(cdt)
    d = q.shape[-1]
    check_arg(d >= 2, "D must be >= 2")
    dsub_actual, nskip = downsample_indices(d, dsub if dsub else d)
    ups = upsampling_factor(disc)
    idx = np.arange(dsub_actual) * nskip

    def conj_r(qe):
        return -kappa * jnp.conj(qe)

    def _warn_if_not_bandlimited():
        # reference warns when the resampling step is ill-posed
        # (fnft__misc.c:370-380); only checkable on concrete (non-traced) data
        if isinstance(q, jax.core.Tracer):
            return
        from fnft_tpu.config import eps_of
        from fnft_tpu.utils.misc import bandlimit_violation
        import math as _math

        viol = float(bandlimit_violation(q, eps_t))
        if viol > _math.sqrt(eps_of(cdt)):
            from fnft_tpu.errors import warn

            warn("Signal does not appear to be bandlimited; the "
                 "interpolation step may be inaccurate. Reduce the step "
                 "size or use a discretization without resampling.")

    import jax

    if ups == 1 and disc not in (Discretization.ES4, Discretization.TES4):
        q_eff = q[..., idx]
        r_eff = conj_r(q_eff)
    elif disc in (Discretization.CF4_2, Discretization.SPLIT4A4,
                  Discretization.SPLIT4B4):
        _warn_if_not_bandlimited()
        s = math.sqrt(3.0) / 6.0
        shifts = np.array([-eps_t * s * nskip, eps_t * s * nskip])
        q12 = resample(q, eps_t, shifts)        # [..., 2, D]
        w = method_weights(disc)
        q1, q2 = q12[..., 0, idx], q12[..., 1, idx]
        stage0 = w[0] * q1 + w[1] * q2
        stage1 = w[2] * q1 + w[3] * q2
        q_eff = jnp.stack([stage0, stage1], axis=-1).reshape(q.shape[:-1] + (-1,))
        r_eff = conj_r(q_eff)
    elif disc in (Discretization.CF4_3, Discretization.CF5_3,
                  Discretization.CF6_4):
        _warn_if_not_bandlimited()
        node = math.sqrt(3.0 / 20.0) if disc is Discretization.CF4_3 \
            else math.sqrt(15.0) / 10.0  # identical values; kept for clarity
        shifts = np.array([-eps_t * node * nskip, eps_t * node * nskip])
        q13 = resample(q, eps_t, shifts)
        qs = jnp.stack([q13[..., 0, idx], q[..., idx], q13[..., 1, idx]],
                       axis=-1)  # [..., Dsub, 3]
        stages = 3 if disc is not Discretization.CF6_4 else 4
        w = jnp.asarray(method_weights(disc).reshape(stages, 3), dtype=cdt)
        q_eff = jnp.einsum("sn,...dn->...ds", w, qs).reshape(q.shape[:-1] + (-1,))
        if disc is Discretization.CF4_3:
            r_eff = conj_r(q_eff)
        else:
            # complex weights: r stages are weighted combinations of the
            # *conjugated nodes*, not conjugates of q_eff (reference :531-607)
            rs = -kappa * jnp.conj(qs)
            r_eff = jnp.einsum("sn,...dn->...ds", w, rs).reshape(q.shape[:-1] + (-1,))
    elif disc in (Discretization.ES4, Discretization.TES4):
        # 3-slot layout [q, q', q''] with central finite differences
        # (reference :609-633); boundaries use zero exterior samples.
        qsub = q[..., idx]
        h = eps_t * nskip
        qm = jnp.pad(qsub[..., :-1], [(0, 0)] * (qsub.ndim - 1) + [(1, 0)])
        qp = jnp.pad(qsub[..., 1:], [(0, 0)] * (qsub.ndim - 1) + [(0, 1)])
        d1 = (qp - qm) / (2 * h)
        d2 = (qp - 2 * qsub + qm) / (h * h)
        q_eff = jnp.stack([qsub, d1, d2], axis=-1).reshape(q.shape[:-1] + (-1,))
        r_eff = conj_r(q_eff)
    else:
        raise ValueError(f"unknown discretization {disc}")

    first_last = (0, int(idx[-1]))
    return q_eff, r_eff, dsub_actual, first_last


# ---------------------------------------------------------------------------
# Boundary-condition phase factors (fnft__nse_discretization.c:240-379)
# ---------------------------------------------------------------------------

def phase_factor_rho(eps_t: float, t1: float, disc: Discretization) -> float:
    pf = -2.0 * (t1 + eps_t * BOUNDARY_COEFF)
    if disc in (Discretization.SPLIT2A, Discretization.SPLIT2_MODAL):
        pf += eps_t / degree(disc)
    return pf


def phase_factor_a(eps_t: float, d_given: int, t0: float, t1: float,
                   disc: Discretization) -> float:
    pf = (t1 + eps_t * BOUNDARY_COEFF) - (t0 - eps_t * BOUNDARY_COEFF)
    if degree(disc) > 0:  # fast methods carry the z^{-D deg/2} normalization
        pf += -eps_t * d_given
    return pf


def phase_factor_b(eps_t: float, d_given: int, t0: float, t1: float,
                   disc: Discretization) -> float:
    pf = -(t1 + eps_t * BOUNDARY_COEFF) - (t0 - eps_t * BOUNDARY_COEFF)
    if degree(disc) > 0:
        pf += -eps_t * d_given
    if disc in (Discretization.SPLIT2A, Discretization.SPLIT2_MODAL):
        pf += eps_t / degree(disc)
    return pf


def fscatter(q, eps_t: float, kappa: int, disc: Discretization,
             *, normalize: bool = True, want=None):
    """NSE polynomial scattering matrix: builds r = -kappa conj(q) and
    delegates to the AKNS kernel (reference fnft__nse_fscatter.c:34-91)."""
    from fnft_tpu.ops.fscatter import fscatter as akns_fscatter

    q = jnp.asarray(q)
    return akns_fscatter(q, -kappa * jnp.conj(q), eps_t, disc,
                         normalize=normalize, want=want, jsym=kappa)


def scatter_matrix(q, lam, eps_t: float, kappa: int, disc: Discretization,
                   *, derivative: bool = False):
    """NSE slow scattering matrix (reference fnft__nse_scatter_matrix.c:33-87)."""
    from fnft_tpu.ops.scatter import scatter_matrix as akns_scatter_matrix

    q = jnp.asarray(q)
    return akns_scatter_matrix(q, -kappa * jnp.conj(q), lam, eps_t, disc,
                               derivative=derivative)


def newton_base_discretization(disc: Discretization) -> Discretization:
    """Slow scheme used for Newton refinement / norming constants of a fast
    scheme (fnft_nsev.c:675-681, 930-939)."""
    if degree(disc) == 0:
        return disc
    ups = upsampling_factor(disc)
    if ups == 1:
        return Discretization.BO
    if ups == 2:
        return Discretization.CF4_2
    return disc


def xi_map_coeff(disc: Discretization) -> float:
    """z = exp(i * map_coeff * lam * eps_t) with map_coeff = 2/(deg*ups)."""
    return 2.0 / degree1step_total(disc)
