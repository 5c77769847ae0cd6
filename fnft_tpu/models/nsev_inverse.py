"""Inverse NFT for the vanishing-BC NSE.

Rebuild of fnft_nsev_inverse.c:121-1033. Pipeline:

  1. Build a transfer-matrix polynomial from the continuous spectrum:
     * REFLECTION_COEFFICIENT (default): B(z) from an M-point FFT of the
       boundary-compensated spectrum, A(z) = 1 (Skaar et al. 2001);
       or the defocusing-only iterative method (Algorithm 1 of
       arXiv:1607.01305v2) that alternates B <- FFT(rho/sqrt(1+kappa|rho|^2))
       with A <- specfact(B) phase updates.
     * B_OF_XI: B(z) from the FFT, A(z) by spectral factorization.
     * B_OF_TAU: b-coefficients are trapezoid-weighted samples of B(tau),
       A(z) by spectral factorization (ECOC 2017 approach).
  2. Fast inverse scattering (ops.finvscatter) recovers q.
  3. Bound states are added by a classical Darboux transform; with a seed
     potential the CDT uses phi/psi eigenfunctions, without one a
     closed-form recursive multi-soliton formula, both vectorized over the
     time axis with the (small) K-loop unrolled.

Internally the reference's descending-coefficient formulas are kept and
flipped once to this package's ascending convention.
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
from fnft_tpu.models.discretization import Discretization, degree
from fnft_tpu.ops.finvscatter import finvscatter
from fnft_tpu.ops.scatter import scatter_bound_states
from fnft_tpu.ops.specfact import poly_specfact


class InverseContspecType(enum.Enum):   # fnft_nsev_inverse.h:58-62
    REFLECTION_COEFFICIENT = "reflection_coefficient"
    B_OF_XI = "b_of_xi"
    B_OF_TAU = "b_of_tau"


class InverseCstMethod(enum.Enum):      # fnft_nsev_inverse.h:108-113
    DEFAULT = "default"
    TFMATRIX_CONTAINS_REFL_COEFF = "tf_refl"
    TFMATRIX_CONTAINS_AB_FROM_ITER = "tf_ab_iter"
    USE_SEED_POTENTIAL_INSTEAD = "seed_potential"


class InverseDiscspecType(enum.Enum):
    NORMING_CONSTANTS = "norming_constants"
    RESIDUES = "residues"


@dataclasses.dataclass(frozen=True)
class NsevInverseOpts:
    """Defaults mirror fnft_nsev_inverse_default_opts (:26-33)."""

    discretization: Discretization = Discretization.SPLIT2A
    contspec_type: InverseContspecType = InverseContspecType.REFLECTION_COEFFICIENT
    contspec_method: InverseCstMethod = InverseCstMethod.DEFAULT
    discspec_type: InverseDiscspecType = InverseDiscspecType.NORMING_CONSTANTS
    max_iter: int = 100
    oversampling_factor: int = 8


def nsev_inverse_xi_grid(d: int, t_span, m: int,
                         disc: Discretization = Discretization.SPLIT2A):
    """Canonical xi grid matching the M-point FFT (fnft_nsev_inverse_XI,
    :40-65): XI = [(-pi + 2pi/M), pi] * deg1 / (2 eps_t)."""
    from fnft_tpu.models.discretization import degree1step_total

    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / (d - 1)
    deg1 = degree1step_total(disc)
    scale = deg1 / (2.0 * eps_t)
    return ((-math.pi + 2.0 * math.pi / m) * scale, math.pi * scale)


def _desc_to_asc(x):
    return x[..., ::-1]


def _remove_bc_and_reorder(contspec, xi_span, m, eps_t, t0, t1, d, ctype,
                           disc):
    """Strip boundary phase factors + FFT ordering (reference :251-296)."""
    xi0, xi1 = xi_span
    eps_xi = (xi1 - xi0) / (m - 1)
    if ctype is InverseContspecType.REFLECTION_COEFFICIENT:
        pf = nse.phase_factor_rho(eps_t, t1, disc)
    else:
        pf = nse.phase_factor_b(eps_t, d, t0, t1, disc)
    rdt = jnp.real(contspec).dtype
    xi = xi0 + eps_xi * jnp.arange(m, dtype=rdt)
    cs = contspec * jnp.exp(-1j * xi * pf)
    reordered = jnp.concatenate([cs[m // 2 - 1:], cs[: m // 2 - 1]])
    return cs, reordered


def _tm_from_b_fft(b_fft, m, deg, kappa, cdt):
    """Descending-order B blocks from FFT coefficients (reference :344-358)."""
    i0 = 0 if deg <= m - 1 else deg - (m - 1)
    idx = np.arange(deg + 1)
    valid = idx >= i0
    tm21_d = jnp.where(jnp.asarray(valid),
                       jnp.take(b_fft, jnp.asarray((deg - idx) % m)), 0.0) / m
    tm12_d = jnp.where(jnp.asarray(valid),
                       -kappa * jnp.conj(
                           jnp.take(b_fft, jnp.asarray((m - 1 - deg + idx) % m))) / m,
                       0.0)
    return tm12_d.astype(cdt), tm21_d.astype(cdt)


def _build_tm_reflection(contspec, xi_span, m, d, t0, t1, deg, kappa, disc,
                         opts):
    eps_t = (t1 - t0) / (d - 1)
    cdt = complex_dtype_of(contspec)
    _, reordered = _remove_bc_and_reorder(
        contspec, xi_span, m, eps_t, t0, t1, d,
        InverseContspecType.REFLECTION_COEFFICIENT, disc)
    b_fft = jnp.fft.fft(reordered)
    tm12_d, tm21_d = _tm_from_b_fft(b_fft, m, deg, kappa, cdt)
    tm11_d = jnp.zeros(deg + 1, dtype=cdt).at[deg].set(1.0)   # A(z) = 1
    tm22_d = jnp.zeros(deg + 1, dtype=cdt).at[0].set(1.0)     # z^deg
    tm = jnp.stack([jnp.stack([tm11_d, tm12_d]),
                    jnp.stack([tm21_d, tm22_d])])
    return _desc_to_asc(tm)


def _build_tm_reflection_iter(contspec, xi_span, m, d, t0, t1, deg, kappa,
                              disc, opts):
    """Defocusing-only iterative method (reference :375-507)."""
    check_arg(kappa == -1, "AB_FROM_ITER requires the defocusing case")
    check_arg(m == d and deg == d, "AB_FROM_ITER requires M == D")
    eps_t = (t1 - t0) / (d - 1)
    cdt = complex_dtype_of(contspec)
    cs, reordered = _remove_bc_and_reorder(
        contspec, xi_span, m, eps_t, t0, t1, d,
        InverseContspecType.REFLECTION_COEFFICIENT, disc)

    eps = eps_of(cdt)
    reordered_cur = reordered
    prev_change = np.inf
    prev_change_diff = np.inf
    a_coeffs = b_coeffs = None
    for _ in range(opts.max_iter):
        x = reordered_cur / jnp.sqrt(1.0 + kappa * jnp.abs(reordered_cur) ** 2) / d
        b = jnp.fft.fft(x)
        # reference swaps b[i] <-> b[D-1-i] for i < D/2, i.e. a full reversal
        b_coeffs = b[::-1]
        a_coeffs = poly_specfact(_desc_to_asc(b_coeffs),
                                 oversampling_factor=32, kappa=kappa)
        a_coeffs = _desc_to_asc(a_coeffs)  # back to descending
        phases = jnp.fft.ifft(a_coeffs[::-1]) * d
        ph = jnp.angle(phases)
        cur_change = float(jnp.sum(jnp.abs(ph)) / d)
        reordered_cur = jnp.concatenate(
            [cs[m // 2 - 1:], cs[: m // 2 - 1]]) * jnp.exp(1j * ph)
        change_diff = abs(cur_change - prev_change)
        if change_diff < 10 * eps:
            break
        prev_change = cur_change
        if change_diff > 0.9 * prev_change_diff:
            break
        prev_change_diff = change_diff
    else:
        warn("Maximum iterations reached when constructing transfer matrix.")

    idx = np.arange(d)
    tm11_d = jnp.zeros(deg + 1, dtype=cdt).at[1 + idx].set(a_coeffs[:d])
    tm12_d = jnp.zeros(deg + 1, dtype=cdt).at[idx].set(
        -kappa * jnp.conj(b_coeffs[d - 1 - idx]))
    tm21_d = jnp.zeros(deg + 1, dtype=cdt).at[1 + idx].set(b_coeffs[:d])
    tm22_d = jnp.zeros(deg + 1, dtype=cdt).at[idx].set(a_coeffs[d - 1 - idx])
    tm = jnp.stack([jnp.stack([tm11_d, tm12_d]),
                    jnp.stack([tm21_d, tm22_d])])
    return _desc_to_asc(tm)


def _build_tm_b_of_xi(contspec, xi_span, m, d, t0, t1, deg, kappa, disc,
                      opts):
    """B(z) from FFT of b(xi), A(z) by spectral factorization (:560-627)."""
    eps_t = (t1 - t0) / (d - 1)
    cdt = complex_dtype_of(contspec)
    _, reordered = _remove_bc_and_reorder(
        contspec, xi_span, m, eps_t, t0, t1, d,
        InverseContspecType.B_OF_XI, disc)
    b_fft = jnp.fft.fft(reordered)
    tm12_d, tm21_d = _tm_from_b_fft(b_fft, m, deg, kappa, cdt)
    a_asc = poly_specfact(_desc_to_asc(tm21_d),
                          oversampling_factor=opts.oversampling_factor,
                          kappa=kappa)
    tm11_d = _desc_to_asc(a_asc)
    tm22_d = tm11_d[::-1]
    tm = jnp.stack([jnp.stack([tm11_d, tm12_d]),
                    jnp.stack([tm21_d, tm22_d])])
    return _desc_to_asc(tm)


def _build_tm_b_of_tau(contspec, m, d, t0, t1, deg, kappa, disc, opts):
    """b-coefficients directly from B(tau) samples (:632-678)."""
    check_arg(m == d, "B_OF_TAU requires M == D")
    check_arg(abs(t0 + t1) < 1e-12, "B_OF_TAU requires T[0] == -T[1]")
    eps_t = (t1 - t0) / (d - 1)
    cdt = complex_dtype_of(contspec)
    deg1 = degree(disc)
    b = 2.0 * eps_t * contspec.astype(cdt) / deg1
    b = b.at[0].multiply(0.5).at[d - 1].multiply(0.5)
    a_asc = poly_specfact(_desc_to_asc(b),
                          oversampling_factor=opts.oversampling_factor,
                          kappa=kappa)
    a = _desc_to_asc(a_asc)  # descending, length d

    idx = np.arange(d)
    tm11_d = jnp.zeros(deg + 1, dtype=cdt).at[1 + idx].set(a)
    tm12_d = jnp.zeros(deg + 1, dtype=cdt).at[idx].set(
        -kappa * jnp.conj(b[d - 1 - idx]))
    tm21_d = jnp.zeros(deg + 1, dtype=cdt).at[1 + idx].set(b)
    tm22_d = jnp.zeros(deg + 1, dtype=cdt).at[idx].set(a[d - 1 - idx])
    tm = jnp.stack([jnp.stack([tm11_d, tm12_d]),
                    jnp.stack([tm21_d, tm22_d])])
    return _desc_to_asc(tm)


@partial(jax.jit, static_argnums=(2,))
def _precompensate_cdt(contspec, xi_span, m, bound_states):
    """Blaschke-factor precompensation (reference :1013-1033)."""
    xi0, xi1 = xi_span
    rdt = jnp.real(contspec).dtype
    xi = xi0 + (xi1 - xi0) / (m - 1) * jnp.arange(m, dtype=rdt)
    bs = jnp.asarray(bound_states)
    out = contspec
    for i in range(bs.shape[0]):
        out = out * (xi - bs[i]) / (xi - jnp.conj(bs[i]))
    return out


# ---------------------------------------------------------------------------
# Darboux: adding the discrete spectrum
# ---------------------------------------------------------------------------

@jax.jit
def _multisoliton(bound_states, norm_consts, tgrid, zc_point):
    """Closed-form recursive multi-soliton (reference :796-840), vectorized
    over the time axis; the K^2 recursion is unrolled (K is small) inside
    one jitted program."""
    bs = jnp.asarray(bound_states)
    k = bs.shape[0]
    norm_consts = jnp.asarray(norm_consts)
    bs_diff = 2j * jnp.imag(bs)

    def sweep(t_local, consts, conj_result):
        rhok = [consts[i] * jnp.exp(2j * bs[i] * t_local) for i in range(k)]
        qt = jnp.zeros_like(t_local, dtype=bs.dtype)
        for i in range(k):
            rho = rhok[i]
            rhoc = jnp.conj(rho)
            f = bs_diff[i] / (1.0 + jnp.abs(rho) ** 2)
            qt = qt + 2j * rhoc * f
            for j in range(i + 1, k):
                rhok[j] = ((bs[j] - bs[i]) * rhok[j] + (rhok[j] - rho) * f) / \
                    (bs[j] - jnp.conj(bs[i]) - (1.0 + rhoc * rhok[j]) * f)
        return jnp.conj(qt) if conj_result else qt

    q_pos = sweep(tgrid, list(norm_consts), False)
    inv_consts = [1.0 / c for c in norm_consts]
    q_neg = sweep(-tgrid, inv_consts, True)
    n = jnp.arange(tgrid.shape[0])
    return jnp.where(n >= zc_point, q_pos, q_neg)


def _half_step_matrix(qn, l, h):
    """BO half-step matrix for the CDT eigenfunctions (reference :934-960);
    ks == 0 degenerates to the identity, matching the C branch."""
    ks = -(jnp.abs(qn) ** 2) - l * l
    small = ks == 0
    k = jnp.sqrt(jnp.where(small, 1.0, ks))
    ch = jnp.cosh(k * h)
    sh = jnp.sinh(k * h) / k
    u1 = 1j * l * sh
    m = jnp.stack([
        jnp.stack([ch - u1, qn * sh], axis=-1),
        jnp.stack([-jnp.conj(qn) * sh, ch + u1], axis=-1),
    ], axis=-2)
    eye = jnp.broadcast_to(jnp.eye(2, dtype=m.dtype), m.shape)
    return jnp.where(small[..., None, None], eye, m)


def _m2x2(b, a):
    """Explicit (b @ a) on [..., 2, 2] stacks (a 2-length contracting dim
    in einsum/matmul defeats XLA:CPU fusion; cf. ops.poly._mat2x2_mul)."""
    b00, b01 = b[..., 0, 0], b[..., 0, 1]
    b10, b11 = b[..., 1, 0], b[..., 1, 1]
    a00, a01 = a[..., 0, 0], a[..., 0, 1]
    a10, a11 = a[..., 1, 0], a[..., 1, 1]
    return jnp.stack([
        jnp.stack([b00 * a00 + b01 * a10, b00 * a01 + b01 * a11], axis=-1),
        jnp.stack([b10 * a00 + b11 * a10, b10 * a01 + b11 * a11], axis=-1),
    ], axis=-2)


def _compute_eigenfunctions(bound_states, q, t0, t1):
    """phi/psi trajectories at all samples (reference :908-1006).

    The reference integrates sequentially over the time grid
    (fnft__nsev_inverse.c CDT eigenfunction loops); here the per-step BO
    matrices are built in one batched pass and the D-deep matrix
    recurrence is a log-depth ``associative_scan`` of 2x2 products —
    prefix products for phi, suffix products of the inverses for psi.

    Returns (phi, psi), each [D, K, 2].
    """
    cdt = q.dtype
    d = q.shape[-1]
    l = jnp.asarray(bound_states).astype(cdt)
    h = ((t1 - t0) / (d - 1)) / 2.0

    # step matrices M[n] = U(q[n+1]) U(q[n]), n = 0..D-2: [D-1, K, 2, 2]
    m = _m2x2(_half_step_matrix(q[1:, None], l, h),
              _half_step_matrix(q[:-1, None], l, h))

    phi0 = jnp.stack([jnp.exp(-1j * l * t0), jnp.zeros_like(l)], axis=-1)
    # P[n] = M[n] @ ... @ M[0]; phi[n+1] = P[n] @ phi0
    pref = jax.lax.associative_scan(lambda a, b: _m2x2(b, a), m, axis=0)
    phi_traj = jnp.stack([
        pref[..., 0, 0] * phi0[..., 0] + pref[..., 0, 1] * phi0[..., 1],
        pref[..., 1, 0] * phi0[..., 0] + pref[..., 1, 1] * phi0[..., 1],
    ], axis=-1)
    phi = jnp.concatenate([phi0[None], phi_traj], axis=0)

    psi_end = jnp.stack([jnp.zeros_like(l), jnp.exp(1j * l * t1)], axis=-1)
    # psi[n] = inv(M[n]) @ ... @ inv(M[D-2]) @ psi_end: suffix product =
    # reversed prefix product of the reversed inverse matrices
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    minv = jnp.stack([
        jnp.stack([m[..., 1, 1], -m[..., 0, 1]], axis=-1),
        jnp.stack([-m[..., 1, 0], m[..., 0, 0]], axis=-1),
    ], axis=-2) / det[..., None, None]
    suff = jax.lax.associative_scan(lambda a, b: _m2x2(b, a),
                                    minv[::-1], axis=0)[::-1]
    psi_traj = jnp.stack([
        suff[..., 0, 0] * psi_end[..., 0] + suff[..., 0, 1] * psi_end[..., 1],
        suff[..., 1, 0] * psi_end[..., 0] + suff[..., 1, 1] * psi_end[..., 1],
    ], axis=-1)
    psi = jnp.concatenate([psi_traj, psi_end[None]], axis=0)
    return phi, psi


@jax.jit
def _darboux_with_seed(bound_states, norm_consts, q_seed, t0, t1):
    """CDT on a seed potential (reference :841-891), vectorized over time;
    the K^2 dressing recursion is unrolled inside one jitted program."""
    bs = jnp.asarray(bound_states)
    k = bs.shape[0]
    norm_consts = jnp.asarray(norm_consts)
    phi, psi = _compute_eigenfunctions(bs, q_seed, t0, t1)
    qn = q_seed
    s1: list = []
    s2: list = []
    for i in range(k):
        phi1, phi2 = phi[:, i, 0], phi[:, i, 1]
        psi1, psi2 = psi[:, i, 0], psi[:, i, 1]
        for j in range(i):
            tmp = (bs[i] - s1[j]) * phi1 - s2[j] * phi2
            phi2 = jnp.conj(s2[j]) * phi1 + (bs[i] - jnp.conj(s1[j])) * phi2
            phi1 = tmp
            tmp = (bs[i] - s1[j]) * psi1 - s2[j] * psi2
            psi2 = jnp.conj(s2[j]) * psi1 + (bs[i] - jnp.conj(s1[j])) * psi2
            psi1 = tmp
        beta = (phi1 - norm_consts[i] * psi1) / (phi2 - norm_consts[i] * psi2)
        b2 = jnp.abs(beta) ** 2
        s1.append((b2 * bs[i] + jnp.conj(bs[i])) / (1.0 + b2))
        s2.append((2j * jnp.imag(bs[i]) * beta) / (1.0 + b2))
        qn = qn - 2j * s2[i]
    return qn


def _add_discrete_spectrum(bound_states, normconsts_or_residues, q, t0, t1,
                           have_contspec, opts):
    """Reference add_discrete_spectrum (:680-906)."""
    d = q.shape[-1]
    eps_t = (t1 - t0) / (d - 1)
    bs = np.asarray(bound_states)
    nc = np.asarray(normconsts_or_residues)
    order = np.argsort(-np.imag(bs), kind="stable")
    bs, nc = bs[order], nc[order]
    if len(bs) > 1 and np.any(bs[1:] == bs[:-1]):
        raise ValueError("bound states must be simple (multiplicity 1)")

    if opts.discspec_type is InverseDiscspecType.RESIDUES:
        if have_contspec:
            a_vals, _, _ = scatter_bound_states(
                q, -jnp.conj(q), jnp.asarray(bs), eps_t, t0, t1,
                Discretization.BO, skip_b=True)
            acoeff = np.asarray(a_vals)
        else:
            acoeff = np.ones(len(bs), dtype=complex)
        for i in range(len(bs)):
            tmp = acoeff[i]
            for j in range(len(bs)):
                if j != i:
                    tmp *= (bs[i] - bs[j]) / (bs[i] - np.conj(bs[j]))
            nc[i] = (nc[i] / (2j * np.imag(bs[i]))) * tmp

    rdt = jnp.real(q).dtype
    tgrid = t0 + eps_t * jnp.arange(d, dtype=rdt)
    use_seed = (have_contspec or opts.contspec_method is
                InverseCstMethod.USE_SEED_POTENTIAL_INSTEAD)
    if not use_seed:
        zc = int(np.searchsorted(np.asarray(tgrid), 0.0))
        return _multisoliton(bs, nc, tgrid, zc)
    return _darboux_with_seed(bs, nc, q, t0, t1)


def nsev_inverse(contspec, xi_span, d: int, t_span, *, kappa: int = +1,
                 bound_states=None, normconsts_or_residues=None,
                 seed_potential=None,
                 opts: NsevInverseOpts | None = None):
    """Inverse NFT: recover D time-domain samples (fnft_nsev_inverse:121).

    Args:
      contspec: M samples of the chosen contspec representation on the
        canonical xi grid (see :func:`nsev_inverse_xi_grid`), or None.
      xi_span: (XI0, XI1) grid bounds (ignored for B_OF_TAU).
      d: number of output samples; must be a power of two.
      t_span: (T0, T1).
      kappa: +1 focusing / -1 defocusing.
      bound_states / normconsts_or_residues: discrete spectrum (kappa=+1).

    Returns q ``[d]``.
    """
    opts = opts or NsevInverseOpts()
    disc = opts.discretization
    check_arg(disc in (Discretization.SPLIT2A, Discretization.SPLIT2_MODAL),
              "inverse supports 2SPLIT2A / 2SPLIT2_MODAL")
    check_arg(d >= 2 and (d & (d - 1)) == 0, "D must be a power of two")
    t0, t1 = float(t_span[0]), float(t_span[1])
    check_arg(t0 < t1, "T[0] < T[1] required")
    check_arg(kappa in (-1, 1), "kappa must be +-1")
    k = 0 if bound_states is None else len(np.asarray(bound_states))
    if k > 0:
        check_arg(kappa == +1, "discrete spectrum requires kappa = +1")
        check_arg(bool(np.all(np.imag(np.asarray(bound_states)) > 0)),
                  "bound states must lie strictly in the upper half plane")
        check_arg(normconsts_or_residues is not None,
                  "norming constants / residues required with bound states")
    check_arg(contspec is not None or k > 0,
              "neither contspec nor discrete spectrum provided")

    q = None
    if contspec is not None:
        contspec = jnp.asarray(contspec)
        m = contspec.shape[-1]
        check_arg(m % 2 == 0 and m >= d, "M must be even and >= D")
        deg = d * degree(disc)
        eps_t = (t1 - t0) / (d - 1)

        ctype = opts.contspec_type
        if ctype is InverseContspecType.REFLECTION_COEFFICIENT:
            if k > 0:
                contspec = _precompensate_cdt(contspec, xi_span, m,
                                              bound_states)
            if opts.contspec_method is InverseCstMethod.TFMATRIX_CONTAINS_AB_FROM_ITER:
                tm = _build_tm_reflection_iter(contspec, xi_span, m, d, t0,
                                               t1, deg, kappa, disc, opts)
            else:
                tm = _build_tm_reflection(contspec, xi_span, m, d, t0, t1,
                                          deg, kappa, disc, opts)
        elif ctype is InverseContspecType.B_OF_XI:
            tm = _build_tm_b_of_xi(contspec, xi_span, m, d, t0, t1, deg,
                                   kappa, disc, opts)
        elif ctype is InverseContspecType.B_OF_TAU:
            tm = _build_tm_b_of_tau(contspec, m, d, t0, t1, deg, kappa, disc,
                                    opts)
        else:
            raise ValueError(ctype)

        q = finvscatter(tm, eps_t, kappa, disc)

    if k > 0:
        if q is None:
            # the reference passes a seed through the in/out q array when
            # csmethod is USE_SEED_POTENTIAL_INSTEAD (addsoliton test)
            if seed_potential is not None:
                q = jnp.asarray(seed_potential).astype(
                    complex_dtype_of(jnp.asarray(seed_potential)))
            else:
                q = jnp.zeros(d, dtype=complex_dtype_of(np.asarray(bound_states)))
        q = _add_discrete_spectrum(np.asarray(bound_states),
                                   np.asarray(normconsts_or_residues),
                                   q, t0, t1, contspec is not None, opts)
    return q
