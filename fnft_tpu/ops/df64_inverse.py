"""Fast inverse scattering in double-float (float32-pair) arithmetic.

df64 counterpart of ops.finvscatter (reference
fnft__nse_finvscatter.c:29-366): the divide-and-conquer layer peel runs
entirely on cdf coefficient pytrees — FFT polynomial products via
fft_df64, base-case one-step inverses with a division-free df64 rsqrt —
so a float32-only device recovers time-domain samples at reference
(double) accuracy from pure float32 ops.

The only transcendental of the 2SPLIT2A base case, q = atan|Q| e^{i arg Q},
affects just the OUTPUT map (never the recursion state), so it is applied
on the host in float64 after the peel; 2SPLIT2_MODAL's map is linear.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from fnft_tpu.models.discretization import Discretization, degree
from fnft_tpu.ops.df64 import (
    _cdf_index,
    cdf_add,
    cdf_div,
    cdf_from_c128,
    cdf_mul,
    cdf_to_c128,
    df_mul,
    df_rsqrt,
    fft_df64,
)
from fnft_tpu.ops.df64 import next_fft_length_df64 as next_fft_length  # 2^a or 3*2^a

_SCAN_CUTOFF = 32  # blocks at or below this degree peel sequentially


def _pad_to(z, length):
    return jax.tree.map(
        lambda t: jnp.pad(t, [(0, 0)] * (t.ndim - 1)
                          + [(0, length - t.shape[-1])]), z)


def _slice_c(z, sl):
    return jax.tree.map(lambda t: t[..., sl], z)


def _polymatmul_df64(a, b, out_len=None):
    """(a @ b)(z) for cdf [..., 2, 2, ca] x [..., 2, 2, cb].

    Thin wrapper over the canonical FFT-domain product in ops.df64
    (first argument there is the LEFT factor), plus the output-length
    slice the peel needs.
    """
    from fnft_tpu.ops.df64 import _matpoly_product_df64

    n_out = a[0][0].shape[-1] + b[0][0].shape[-1] - 1
    out = _matpoly_product_df64(a, b, next_fft_length(n_out))
    return _slice_c(out, slice(0, out_len if out_len is not None else n_out))


def _base_case_df64(t, kappa: int):
    """One-sample inversion: returns (Q cdf scalar, Ti cdf [2,2,2]).

    Q = -kappa conj(T10_0 / T00_0); Ti as in fnft__nse_finvscatter.c:167-227
    but with the sample's output map deferred to the host.
    """
    t00 = _cdf_index(t, (Ellipsis, 0, 0, 0))
    t10 = _cdf_index(t, (Ellipsis, 1, 0, 0))
    ratio = cdf_div(t10, t00)
    # Q = -kappa * conj(ratio)
    qr = ((-kappa * ratio[0][0], -kappa * ratio[0][1]),
          (kappa * ratio[1][0], kappa * ratio[1][1]))
    # scl = 1/sqrt(1 + kappa |Q|^2) (real df pair)
    absq2 = cdf_mul(qr, ((qr[0][0], qr[0][1]), (-qr[1][0], -qr[1][1])))[0]
    one = (jnp.ones_like(absq2[0]), jnp.zeros_like(absq2[0]))
    den = _df_addk(one, absq2, kappa)
    scl = df_rsqrt(den)
    scl_c = ((scl[0], scl[1]),
             (jnp.zeros_like(scl[0]), jnp.zeros_like(scl[0])))

    zero = jax.tree.map(jnp.zeros_like, scl_c)
    mscl_q = cdf_mul(scl_c, qr)
    neg_mscl_q = ((-mscl_q[0][0], -mscl_q[0][1]),
                  (-mscl_q[1][0], -mscl_q[1][1]))
    kq_conj = ((kappa * qr[0][0], kappa * qr[0][1]),
               (-kappa * qr[1][0], -kappa * qr[1][1]))
    scl_kq = cdf_mul(scl_c, kq_conj)

    # Ti[i][j] = [coeff0, coeff1]
    entries = [[[zero, scl_c], [zero, neg_mscl_q]],
               [[scl_kq, zero], [scl_c, zero]]]

    def stack(sel):
        return jnp.stack([
            jnp.stack([
                jnp.stack([sel(entries[i][j][k]) for k in range(2)], axis=-1)
                for j in range(2)], axis=-2)
            for i in range(2)], axis=-3)

    ti = ((stack(lambda v: v[0][0]), stack(lambda v: v[0][1])),
          (stack(lambda v: v[1][0]), stack(lambda v: v[1][1])))
    return qr, ti


def _df_addk(x, y, k: int):
    """x + k*y for real df pairs, k in {-1, +1}."""
    from fnft_tpu.ops.df64 import df_add, df_sub

    return df_add(x, y) if k > 0 else df_sub(x, y)


def _peel_scan_df64(t, deg: int, kappa: int):
    """Sequential one-sample peel of a block (cf. finvscatter._peel_scan)."""
    c = deg + 1

    def step(carry, _):
        t_cur, acc = carry
        qq, ti = _base_case_df64(_slice_c(t_cur, slice(0, 2)), kappa)
        t_next = _slice_c(_polymatmul_df64(ti, t_cur), slice(1, c + 1))
        acc = _polymatmul_df64(ti, acc, out_len=c)
        return (t_next, acc), qq

    shape = t[0][0].shape[:-3]
    eye_hi = jnp.zeros(shape + (2, 2, c), jnp.float32)
    eye_hi = eye_hi.at[..., 0, 0, 0].set(1.0).at[..., 1, 1, 0].set(1.0)
    zero = jnp.zeros_like(eye_hi)
    eye = ((eye_hi, zero), (zero, zero))
    (t_fin, ti_total), q_rev = jax.lax.scan(step, (t, eye), None, length=deg)
    # q_rev leaves have the scan axis leading; reverse to natural order
    q = jax.tree.map(lambda a: jnp.moveaxis(a, 0, -1)[..., ::-1], q_rev)
    return q, ti_total


def _recurse_df64(t, deg: int, kappa: int, need_inverse: bool):
    if 1 < deg <= _SCAN_CUTOFF:
        q, ti = _peel_scan_df64(t, deg, kappa)
        return q, (ti if need_inverse else None)
    if deg == 1:
        qq, ti = _base_case_df64(t, kappa)
        q = jax.tree.map(lambda a: a[..., None], qq)
        return q, (ti if need_inverse else None)
    d2 = deg // 2
    t2_approx = _slice_c(t, slice(0, d2 + 1))
    q_hi, t2i = _recurse_df64(t2_approx, d2, kappa, True)
    prod = _polymatmul_df64(t2i, t, out_len=deg + 1)
    t1 = _slice_c(prod, slice(d2, deg + 1))
    q_lo, t1i = _recurse_df64(t1, d2, kappa, need_inverse)
    ti = _polymatmul_df64(t1i, t2i) if need_inverse else None
    q = jax.tree.map(lambda a, b_: jnp.concatenate([a, b_], axis=-1),
                     q_lo, q_hi)
    return q, ti


@partial(jax.jit, static_argnames=("deg", "kappa"))
def _finvscatter_core_traced_df64(t, deg: int, kappa: int):
    q, _ = _recurse_df64(t, deg, kappa, need_inverse=False)
    return q


# staged driver (cf. ops.finvscatter): the df64 recursion also unrolls into
# an O(deg/32)-node XLA program, so large degrees compile for minutes.
# Concrete inputs instead run a host recursion over shape-cached kernels:
# one traced leaf program plus two kernels per level.
_STAGED_LEAF_DEG = 128
_STAGED_MIN_DEG = 2 * _STAGED_LEAF_DEG


@partial(jax.jit, static_argnames=("deg", "kappa", "need_inverse"))
def _recurse_jit_df64(t, deg: int, kappa: int, need_inverse: bool):
    return _recurse_df64(t, deg, kappa, need_inverse)


@partial(jax.jit, static_argnames=("d2", "deg"))
def _t1_stage_df64(t2i, t, d2: int, deg: int):
    prod = _polymatmul_df64(t2i, t, out_len=deg + 1)
    return _slice_c(prod, slice(d2, deg + 1))


@jax.jit
def _merge_stage_df64(t1i, t2i):
    return _polymatmul_df64(t1i, t2i)


def _recurse_staged_df64(t, deg: int, kappa: int, need_inverse: bool,
                         out: list, offset: int):
    if deg <= _STAGED_LEAF_DEG:
        q, ti = _recurse_jit_df64(t, deg, kappa, need_inverse)
        out.append((offset, q))
        return ti
    d2 = deg // 2
    t2i = _recurse_staged_df64(_slice_c(t, slice(0, d2 + 1)), d2, kappa,
                               True, out, offset + d2)
    t1 = _t1_stage_df64(t2i, t, d2, deg)
    t1i = _recurse_staged_df64(t1, d2, kappa, need_inverse, out, offset)
    return _merge_stage_df64(t1i, t2i) if need_inverse else None


def _finvscatter_core_df64(t, deg: int, kappa: int):
    if deg < _STAGED_MIN_DEG:
        return _finvscatter_core_traced_df64(t, deg, kappa)
    out: list = []
    _recurse_staged_df64(t, deg, kappa, False, out, 0)
    out.sort(key=lambda kv: kv[0])
    blocks = [blk for _, blk in out]
    return jax.tree.map(
        lambda *parts: jnp.concatenate(parts, axis=-1), *blocks)


def finvscatter_df64(transfer_matrix, eps_t: float, kappa: int,
                     disc: Discretization = Discretization.SPLIT2A):
    """Recover D samples from T [2, 2, deg+1] (complex128 in/out).

    The peel runs in float32-pair arithmetic on device; the per-sample
    output map (atan for 2SPLIT2A, linear for 2SPLIT2_MODAL) is applied
    in float64 on the host.
    """
    tm = np.asarray(transfer_matrix, dtype=np.complex128)
    deg = tm.shape[-1] - 1
    d = deg // max(degree(disc), 1)
    if d < 2 or d & (d - 1):
        raise ValueError("D must be a positive power of two")
    if disc not in (Discretization.SPLIT2A, Discretization.SPLIT2_MODAL):
        raise ValueError(
            f"finvscatter supports 2SPLIT2A/2SPLIT2_MODAL, got {disc}")
    qq = cdf_to_c128(_finvscatter_core_df64(cdf_from_c128(tm), deg, kappa))
    return _output_map(qq, eps_t, disc)


def _output_map(qq, eps_t: float, disc: Discretization):
    """Per-sample output map, host-side float64 (see module docstring)."""
    if disc is Discretization.SPLIT2A:
        return np.arctan(np.abs(qq)) * np.exp(1j * np.angle(qq)) / eps_t
    if disc is Discretization.SPLIT2_MODAL:
        return qq / eps_t
    raise ValueError(f"finvscatter supports 2SPLIT2A/2SPLIT2_MODAL, got {disc}")


def _validate(d: int, m: int | None, kappa: int, disc: Discretization):
    if disc not in (Discretization.SPLIT2A, Discretization.SPLIT2_MODAL):
        raise ValueError(
            f"df64 inverse supports 2SPLIT2A/2SPLIT2_MODAL, got {disc}")
    if kappa not in (-1, 1):
        raise ValueError("kappa must be +-1")
    if d < 2 or d & (d - 1):
        raise ValueError("D must be a positive power of two")
    if m is not None and (m < d or m & (m - 1)):
        raise ValueError("M must be a power of two >= D (df64 radix-2 FFT)")


def _prep_contspec_host(cs, xi_span, d: int, t_span, disc, ctype: str):
    """Shared prologue: exact complex128 phase strip + FFT reorder
    (the phases are static host constants; reference :251-296)."""
    from fnft_tpu.models import nse

    m = cs.shape[-1]
    t0, t1 = float(t_span[0]), float(t_span[1])
    xi0, xi1 = float(xi_span[0]), float(xi_span[1])
    eps_t = (t1 - t0) / (d - 1)
    eps_xi = (xi1 - xi0) / (m - 1)
    xi = xi0 + eps_xi * np.arange(m)
    if ctype == "rho":
        pf = float(nse.phase_factor_rho(eps_t, t1, disc))
    else:
        pf = float(nse.phase_factor_b(eps_t, d, t0, t1, disc))
    weighted = cs * np.exp(-1j * xi * pf)
    return np.concatenate([weighted[m // 2 - 1:], weighted[: m // 2 - 1]])


def _b_blocks_np(b_fft, deg: int, m: int, kappa: int):
    """Descending-order B blocks from FFT values (reference :344-358).

    Single shared copy of the subtle index maps (the jnp twin lives in
    models.nsev_inverse._tm_from_b_fft). Exact: gathers, conj, sign, and
    the 1/m power-of-two scale preserve df64 values bit-for-bit.
    """
    idx = np.arange(deg + 1)
    i0 = 0 if deg <= m - 1 else deg - (m - 1)
    valid = idx >= i0
    tm21_d = np.where(valid, b_fft[(deg - idx) % m], 0.0) / m
    tm12_d = np.where(valid,
                      -kappa * np.conj(b_fft[(m - 1 - deg + idx) % m]),
                      0.0) / m
    return tm12_d, tm21_d


def _peel(tm_desc, eps_t: float, kappa: int, disc: Discretization):
    """Descending complex128 transfer matrix -> q via the df64 peel."""
    deg = tm_desc.shape[-1] - 1
    qq = cdf_to_c128(_finvscatter_core_df64(
        cdf_from_c128(np.ascontiguousarray(tm_desc[..., ::-1])), deg, kappa))
    return _output_map(qq, eps_t, disc)


def nsev_inverse_df64(contspec, xi_span, d: int, t_span, *, kappa: int = +1,
                      disc: Discretization = Discretization.SPLIT2A):
    """End-to-end inverse NFT (continuous spectrum only) in df64.

    The reflection-coefficient transfer matrix of the reference's DEFAULT
    method (fnft_nsev_inverse.c:302-370) is transcendental-free: boundary
    phases are static host constants, the reorder/index maps are static
    gathers, B(z) comes from one M-point df64 FFT, and A(z) := 1. The
    heavy work (FFT + layer peel) runs in float32-pair arithmetic; output
    accuracy matches the complex128 driver to ~1e-12 where complex64 errs
    ~1e-6. ``contspec`` is rho on the canonical xi grid.
    """
    cs = np.asarray(contspec, dtype=np.complex128)
    m = cs.shape[-1]
    _validate(d, m, kappa, disc)
    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / (d - 1)
    deg = d * degree(disc)

    reordered = _prep_contspec_host(cs, xi_span, d, t_span, disc, "rho")
    b_fft = np.asarray(cdf_to_c128(fft_df64(cdf_from_c128(reordered), m)))
    tm12_d, tm21_d = _b_blocks_np(b_fft, deg, m, kappa)
    tm11_d = np.zeros(deg + 1, np.complex128)
    tm11_d[deg] = 1.0                                  # A(z) = 1
    tm22_d = np.zeros(deg + 1, np.complex128)
    tm22_d[0] = 1.0                                    # z^deg
    tm_desc = np.stack([np.stack([tm11_d, tm12_d]),
                        np.stack([tm21_d, tm22_d])])
    return _peel(tm_desc, eps_t, kappa, disc)


def nsev_inverse_b_of_xi_df64(contspec, xi_span, d: int, t_span, *,
                              kappa: int = -1,
                              disc: Discretization = Discretization.SPLIT2A,
                              oversampling_factor: int = 8):
    """Inverse NFT from b(xi) in df64 (B(z) FFT + spectral factorization).

    Mirrors models.nsev_inverse._build_tm_b_of_xi (reference :560-627):
    the data-dependent FFT runs in df64 on device, A(z) comes from
    :func:`fnft_tpu.ops.df64.poly_specfact_df64`, and the heavy layer
    peel runs in df64. Host glue is pure numpy float64 (no jax x64
    dependency), so the path works with x64 off.
    """
    from fnft_tpu.ops.df64 import poly_specfact_df64

    cs = np.asarray(contspec, dtype=np.complex128)
    m = cs.shape[-1]
    _validate(d, m, kappa, disc)
    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / (d - 1)
    deg = d * degree(disc)

    reordered = _prep_contspec_host(cs, xi_span, d, t_span, disc, "b")
    b_fft = np.asarray(cdf_to_c128(fft_df64(cdf_from_c128(reordered), m)))
    tm12_d, tm21_d = _b_blocks_np(b_fft, deg, m, kappa)
    a_asc = poly_specfact_df64(tm21_d[::-1],
                               oversampling_factor=oversampling_factor,
                               kappa=kappa)
    tm11_d = a_asc[::-1]
    tm22_d = a_asc
    tm_desc = np.stack([np.stack([tm11_d, tm12_d]),
                        np.stack([tm21_d, tm22_d])])
    return _peel(tm_desc, eps_t, kappa, disc)


def nsev_inverse_b_of_tau_df64(contspec, d: int, t_span, *,
                               kappa: int = -1,
                               disc: Discretization = Discretization.SPLIT2A,
                               oversampling_factor: int = 8):
    """Inverse NFT from B(tau) samples in df64 (reference :632-678).

    The b-coefficients are exact rescalings of the input samples
    (trapezoid end weights), A(z) comes from the df64 spectral
    factorization, and the layer peel runs in df64.
    """
    from fnft_tpu.ops.df64 import poly_specfact_df64

    cs = np.asarray(contspec, dtype=np.complex128)
    m = cs.shape[-1]
    _validate(d, None, kappa, disc)
    if m != d:
        raise ValueError("B_OF_TAU requires M == D")
    t0, t1 = float(t_span[0]), float(t_span[1])
    if abs(t0 + t1) > 1e-12:
        raise ValueError("B_OF_TAU requires T[0] == -T[1]")
    eps_t = (t1 - t0) / (d - 1)
    deg1 = degree(disc)
    deg = d * deg1

    b = 2.0 * eps_t * cs / deg1                       # descending
    b[0] *= 0.5
    b[d - 1] *= 0.5
    a_asc = poly_specfact_df64(b[::-1],
                               oversampling_factor=oversampling_factor,
                               kappa=kappa)
    a = a_asc[::-1]                                   # descending, length d

    idx = np.arange(d)
    tm11_d = np.zeros(deg + 1, np.complex128)
    tm11_d[1 + idx] = a
    tm12_d = np.zeros(deg + 1, np.complex128)
    tm12_d[idx] = -kappa * np.conj(b[d - 1 - idx])
    tm21_d = np.zeros(deg + 1, np.complex128)
    tm21_d[1 + idx] = b
    tm22_d = np.zeros(deg + 1, np.complex128)
    tm22_d[idx] = a[d - 1 - idx]
    tm_desc = np.stack([np.stack([tm11_d, tm12_d]),
                        np.stack([tm21_d, tm22_d])])
    return _peel(tm_desc, eps_t, kappa, disc)
