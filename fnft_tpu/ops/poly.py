"""Polynomial kernels: FFT-tree products, chirp-Z evaluation, Horner.

Rebuild of the reference's L2 layer
(src/private/fnft__poly_fmult.c, fnft__poly_chirpz.c, fnft__poly_eval.c).

Conventions (deliberately different from the C reference, which stores
coefficients in descending order):

* Polynomial coefficients are stored in **ascending** order along the last
  axis: ``p[..., k]`` is the coefficient of ``z^k``.
* A stack of 2x2 polynomial matrices has shape ``[..., n, 2, 2, deg+1]``.
* Matrix stacks are in natural time order; the tree computes
  ``P = M[n-1] @ ... @ M[1] @ M[0]`` (later samples multiply from the left),
  matching the scattering-matrix composition in fnft__akns_fscatter.c:919.

Normalization: with ``normalize=True`` every intermediate pair-product is
rescaled by an integer power of two so coefficients stay O(1); the returned
``w`` satisfies ``true = stored * 2**w`` (reference semantics:
fnft__poly_fmult.c:123-150, 330-374).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from fnft_tpu.config import complex_dtype_of
from fnft_tpu.utils.misc import next_fft_length, next_power_of_2


# ---------------------------------------------------------------------------
# FFT-tree polynomial multiplication
# ---------------------------------------------------------------------------

def _exp_from_max(max_abs) -> jnp.ndarray:
    """Integer exponents a with 2**a ~ max_abs (0 where max_abs == 0)."""
    safe = jnp.where(max_abs > 0, max_abs, 1.0)
    return jnp.where(max_abs > 0, jnp.floor(jnp.log2(safe)), 0.0).astype(jnp.int32)


def _rescale_exponents(coeffs, axes) -> jnp.ndarray:
    """Integer exponents a with 2**a ~ max|coeffs| over ``axes`` (0 if zero)."""
    return _exp_from_max(jnp.max(jnp.abs(coeffs), axis=axes))


_DIRECT_CONV_CUTOFF: int | None = None  # None = auto. With the explicit 2x2
                                        # products, 16 and 32 are equal within
                                        # run noise on CPU (D=2^20 tree ~7.1 s
                                        # best either way); 16 is used on
                                        # every platform.


def _conv_cutoff() -> int:
    """Coefficient length below which direct convolution beats FFTs."""
    if _DIRECT_CONV_CUTOFF is not None:
        return _DIRECT_CONV_CUTOFF
    return 16


def _mat2x2_mul(b, a):
    """Explicit (b @ a) over [..., 2, 2, L] stacks, elementwise on L.

    Written out rather than einsum'd: a 2-length contracting dimension
    defeats XLA's elementwise fusion (measured 11x slower on XLA:CPU at
    L = 2^21), while the explicit form is one fused pass.
    """
    b00, b01 = b[..., 0, 0, :], b[..., 0, 1, :]
    b10, b11 = b[..., 1, 0, :], b[..., 1, 1, :]
    a00, a01 = a[..., 0, 0, :], a[..., 0, 1, :]
    a10, a11 = a[..., 1, 0, :], a[..., 1, 1, :]
    return jnp.stack([
        jnp.stack([b00 * a00 + b01 * a10, b00 * a01 + b01 * a11], axis=-2),
        jnp.stack([b10 * a00 + b11 * a10, b10 * a01 + b11 * a11], axis=-2),
    ], axis=-3)


def _matpoly_product(b, a):
    """(b @ a)(z) for two [..., 2, 2, c] stacks -> [..., 2, 2, 2c-1]."""
    c = a.shape[-1]
    if c <= _conv_cutoff():
        out = jnp.zeros(a.shape[:-1] + (2 * c - 1,), dtype=a.dtype)
        for s in range(c):
            out = out.at[..., s: s + c].add(
                _mat2x2_mul(b[..., s: s + 1], a))
        return out
    length = next_fft_length(2 * c - 1)
    fa = jnp.fft.fft(a, n=length, axis=-1)
    fb = jnp.fft.fft(b, n=length, axis=-1)
    # pointwise product in the FFT domain (8 poly products, shared FFTs)
    fc = _mat2x2_mul(fb, fa)
    return jnp.fft.ifft(fc, axis=-1)[..., : 2 * c - 1].astype(a.dtype)


def _tree_level_2x2(p, w, normalize: bool):
    """One tree level: [..., n, 2, 2, c] -> [..., n//2, 2, 2, 2c-1]."""
    a = p[..., 0::2, :, :, :]   # earlier samples
    b = p[..., 1::2, :, :, :]   # later samples
    prod = _matpoly_product(b, a)  # later @ earlier
    if w is not None:
        w = w[..., 0::2] + w[..., 1::2]
    if normalize:
        a_exp = _rescale_exponents(prod, axes=(-3, -2, -1))
        # ldexp, not exp2: XLA:CPU's exp2 is inexact (~1e-6 rel in f32)
        scale = jnp.ldexp(jnp.asarray(1.0, jnp.real(prod).dtype), -a_exp)
        prod = prod * scale[..., None, None, None]
        w = w + a_exp if w is not None else a_exp
    return prod, w


# ---------------------------------------------------------------------------
# Value-space tree levels
#
# Once the polynomials outgrow the direct-convolution cutoff, the tree
# switches to a value representation on exact power-of-two-multiple grids:
# each node is (V, t) where V holds the evaluations of its degree-<=N
# polynomial at the N-th roots of unity and t is the z^N coefficient (the
# one coefficient an N-point grid cannot resolve — it aliases onto z^0 and
# is corrected exactly on the way out).  Per level, the product's values at
# the EVEN points of the doubled 2N grid are the pointwise 2x2 products of
# the factors' existing values (zero transforms); the ODD points cost one
# IFFT + one twisted FFT of size N per matrix entry.  That is 16 size-N
# transforms per pair instead of the classic 12 transforms of 5-smooth
# length ~2.05N — ~35% less FFT work, all at FFT-friendliest sizes, with no
# zero-padding (the reference pads to kiss_fft sizes instead,
# fnft__poly_fmult.c:50-121).
# ---------------------------------------------------------------------------

_VALUE_TREE: bool | None = None  # None = auto (on); False forces classic


def set_value_tree(enabled: bool | None) -> None:
    """Force (True/False) or restore auto (None) the value-space tree."""
    global _VALUE_TREE
    if enabled is not _VALUE_TREE:
        _VALUE_TREE = enabled
        jax.clear_caches()  # flag is read at trace time


def _value_tree_enabled() -> bool:
    return _VALUE_TREE is not False


def _value_enter(p):
    """Coefficients ``[..., n, 2, 2, N+1]`` -> values ``(V, t)``.

    V[..., k] = p(w_N^k) with w_N = exp(-2i pi/N); t = coefficient of z^N
    (z^N == 1 at every grid point, hence the ``+ t``)."""
    n_coef = p.shape[-1]
    t = p[..., n_coef - 1]
    V = jnp.fft.fft(p[..., : n_coef - 1], axis=-1) + t[..., None]
    return V, t


def _half_twiddle(n: int, cdt):
    """w_{2N}^j = exp(-i pi j / N) for j = 0..N-1 (device-computed)."""
    rdt = jnp.zeros((), cdt).real.dtype
    ang = jnp.arange(n, dtype=rdt) * (math.pi / n)
    return jax.lax.complex(jnp.cos(ang), -jnp.sin(ang))


def _value_odd_bins(V, t, tw):
    """Evaluations at the odd points of the 2N grid.

    For p of degree <= N given by (V on the N grid, top coeff t):
    p(w_{2N}^{2k+1}) = FFT_N(p_{0..N-1} * w_{2N}^j)_k - t, with
    coefficients from one IFFT.  Two -t corrections fold into one pass:
    IFFT(V)_0 aliases p_0 + t, and tw_0 == 1 with FFT_N(e_0) == 1, so
    FFT_N(IFFT(V) * tw) = FFT_N(p_{0..N-1} * tw) + t; the top-coefficient
    term itself contributes w_{2N}^{N(2k+1)} = -1, i.e. another -t."""
    q = jnp.fft.ifft(V, axis=-1)
    return jnp.fft.fft(q * tw, axis=-1) - (2.0 * t)[..., None]


def _value_level(V, t, w, do_norm: bool):
    """One tree level in value space: N-grid pairs -> 2N-grid products."""
    Va, Vb = V[..., 0::2, :, :, :], V[..., 1::2, :, :, :]
    ta, tb = t[..., 0::2, :, :], t[..., 1::2, :, :]
    n = V.shape[-1]
    tw = _half_twiddle(n, V.dtype)
    even = _mat2x2_mul(Vb, Va)
    odd = _mat2x2_mul(_value_odd_bins(Vb, tb, tw),
                      _value_odd_bins(Va, ta, tw))
    # 2N-grid point 2k is N-grid point k; point 2k+1 is the odd evaluation
    V_out = jnp.stack([even, odd], axis=-1).reshape(
        even.shape[:-1] + (2 * n,))
    t_out = _mat2x2_mul(tb[..., None], ta[..., None])[..., 0]
    if w is not None:
        w = w[..., 0::2] + w[..., 1::2]
    if do_norm:
        max_abs = jnp.maximum(
            jnp.max(jnp.abs(V_out), axis=(-3, -2, -1)),
            jnp.max(jnp.abs(t_out), axis=(-2, -1)))
        a_exp = _exp_from_max(max_abs)
        scale = jnp.ldexp(jnp.asarray(1.0, jnp.real(V_out).dtype), -a_exp)
        V_out = V_out * scale[..., None, None, None]
        t_out = t_out * scale[..., None, None]
        w = w + a_exp if w is not None else a_exp
    return V_out, t_out, w


def _value_exit(V, t, want=None):
    """Values ``(V, t)`` on the N grid -> coefficients ``[..., N+1]``.

    With ``want`` (a tuple of (row, col) matrix entries), only those
    entries are inverse-transformed — the other entries of the returned
    stack are zero.  The drivers typically consume one row or column of
    the final transfer matrix, which saves top-size IFFTs."""
    if want is not None:
        Vs = jnp.stack([V[..., i, j, :] for i, j in want], axis=-2)
        ts = jnp.stack([t[..., i, j] for i, j in want], axis=-1)
        qs = jnp.fft.ifft(Vs, axis=-1)
        qs = qs.at[..., 0].add(-ts)
        qs = jnp.concatenate([qs, ts[..., None]], axis=-1)
        out = jnp.zeros(V.shape[:-1] + (V.shape[-1] + 1,), dtype=V.dtype)
        for k, (i, j) in enumerate(want):
            out = out.at[..., i, j, :].set(qs[..., k, :])
        return out
    q = jnp.fft.ifft(V, axis=-1)
    q = q.at[..., 0].add(-t)
    return jnp.concatenate([q, t[..., None]], axis=-1)


# ---------------------------------------------------------------------------
# J-symmetric value-space levels (NSE/AKNS with r = -kappa conj(q))
#
# Such transfer matrices satisfy the involution P = sigma(P) with
# sigma(P)(z) = z^deg * J conj(P(1/conj(z))) J^{-1}, i.e. in coefficients
#   P22 = rev(conj(P11)),   P12 = -kappa * rev(conj(P21)),
# and the property is closed under products (verified per scheme in
# tests/test_poly_sym.py).  The tree therefore only needs to carry the
# FIRST COLUMN of each node.  In value space the reconstruction is free:
# the grid size always equals the nominal degree N, so at the even grid
# points z^N == 1 (rev(conj(X)) -> conj(X)) and at the odd points of the
# doubled grid z^N == -1 (rev(conj(X)) -> -conj(X)).  Each level costs 8
# size-N transforms per pair instead of 16 and half the pointwise work.
# The scalar side channels are the top (z^N) and zeroth coefficients of
# the carried column: the missing column's top/zeroth coefficients are
# conj of the carried zeroth/top ones.
# ---------------------------------------------------------------------------


def _value_enter_sym(p):
    """Coefficients ``[..., n, 2, 2, N+1]`` -> column state (Vc, tc, cc).

    Vc[..., n, 2, N] holds values of (P11, P21) on the N-grid; tc/cc are
    their z^N / z^0 coefficients."""
    n_coef = p.shape[-1]
    col = p[..., :, 0, :]                      # [..., n, 2(row), N+1]
    tc = col[..., n_coef - 1]
    cc = col[..., 0]
    Vc = jnp.fft.fft(col[..., : n_coef - 1], axis=-1) + tc[..., None]
    return Vc, tc, cc


def _value_level_sym(Vc, tc, cc, w, kappa: int, do_norm: bool):
    """One J-symmetric tree level: N-grid column pairs -> 2N-grid products."""
    Va, Vb = Vc[..., 0::2, :, :], Vc[..., 1::2, :, :]
    ta, tb = tc[..., 0::2, :], tc[..., 1::2, :]
    ca, cb = cc[..., 0::2, :], cc[..., 1::2, :]
    n = Vc.shape[-1]
    tw = _half_twiddle(n, Vc.dtype)
    a11, a21 = Va[..., 0, :], Va[..., 1, :]
    b11, b21 = Vb[..., 0, :], Vb[..., 1, :]
    # even bins (z^N == 1): B12 = -kappa conj(B21), B22 = conj(B11)
    even11 = b11 * a11 - kappa * (jnp.conj(b21) * a21)
    even21 = b21 * a11 + jnp.conj(b11) * a21
    # odd bins (z^N == -1): B12 = +kappa conj(B21), B22 = -conj(B11)
    Bo = _value_odd_bins(Vb, tb, tw)
    Ao = _value_odd_bins(Va, ta, tw)
    a11o, a21o = Ao[..., 0, :], Ao[..., 1, :]
    b11o, b21o = Bo[..., 0, :], Bo[..., 1, :]
    odd11 = b11o * a11o + kappa * (jnp.conj(b21o) * a21o)
    odd21 = b21o * a11o - jnp.conj(b11o) * a21o
    V11 = jnp.stack([even11, odd11], axis=-1).reshape(
        even11.shape[:-1] + (2 * n,))
    V21 = jnp.stack([even21, odd21], axis=-1).reshape(
        even21.shape[:-1] + (2 * n,))
    V_out = jnp.stack([V11, V21], axis=-2)
    # scalar side channels: top(B12) = -kappa conj(c_B21), top(B22) =
    # conj(c_B11); zeroth(B12) = -kappa conj(t_B21), zeroth(B22) = conj(t_B11)
    t11 = tb[..., 0] * ta[..., 0] - kappa * (jnp.conj(cb[..., 1]) * ta[..., 1])
    t21 = tb[..., 1] * ta[..., 0] + jnp.conj(cb[..., 0]) * ta[..., 1]
    c11 = cb[..., 0] * ca[..., 0] - kappa * (jnp.conj(tb[..., 1]) * ca[..., 1])
    c21 = cb[..., 1] * ca[..., 0] + jnp.conj(tb[..., 0]) * ca[..., 1]
    t_out = jnp.stack([t11, t21], axis=-1)
    c_out = jnp.stack([c11, c21], axis=-1)
    if w is not None:
        w = w[..., 0::2] + w[..., 1::2]
    if do_norm:
        # |column 2| == |column 1| pointwise and |t12|,|t22| == |c21|,|c11|,
        # so the carried state covers the full matrix's magnitude
        max_abs = jnp.maximum(
            jnp.max(jnp.abs(V_out), axis=(-2, -1)),
            jnp.maximum(jnp.max(jnp.abs(t_out), axis=-1),
                        jnp.max(jnp.abs(c_out), axis=-1)))
        a_exp = _exp_from_max(max_abs)
        scale = jnp.ldexp(jnp.asarray(1.0, jnp.real(V_out).dtype), -a_exp)
        V_out = V_out * scale[..., None, None]
        t_out = t_out * scale[..., None]
        c_out = c_out * scale[..., None]
        w = w + a_exp if w is not None else a_exp
    return V_out, t_out, c_out, w


def _value_exit_sym(Vc, tc, cc, kappa: int, want=None):
    """Column state on the N grid -> coefficients ``[..., n, 2, 2, N+1]``.

    Entries outside ``want`` are zero.  Reconstruction uses the even-grid
    identities (z^N == 1): V22 = conj(V11), V12 = -kappa conj(V21), with
    top coefficients conj(c11) / -kappa conj(c21)."""
    if want is None:
        want = ((0, 0), (0, 1), (1, 0), (1, 1))
    entry = {
        (0, 0): (Vc[..., 0, :], tc[..., 0]),
        (1, 0): (Vc[..., 1, :], tc[..., 1]),
        (1, 1): (jnp.conj(Vc[..., 0, :]), jnp.conj(cc[..., 0])),
        (0, 1): (-kappa * jnp.conj(Vc[..., 1, :]),
                 -kappa * jnp.conj(cc[..., 1])),
    }
    Vs = jnp.stack([entry[ij][0] for ij in want], axis=-2)
    ts = jnp.stack([entry[ij][1] for ij in want], axis=-1)
    qs = jnp.fft.ifft(Vs, axis=-1)
    qs = qs.at[..., 0].add(-ts)
    qs = jnp.concatenate([qs, ts[..., None]], axis=-1)
    n_grid = Vc.shape[-1]
    out = jnp.zeros(Vc.shape[:-2] + (2, 2, n_grid + 1), dtype=Vc.dtype)
    for k, (i, j) in enumerate(want):
        out = out.at[..., i, j, :].set(qs[..., k, :])
    return out


# ---------------------------------------------------------------------------
# Real-coefficient value-space levels (KdV: r = -1 and real u give transfer
# matrices with all-real polynomial coefficients, closed under products).
#
# Real coefficients make every value grid conjugate-symmetric,
# V[N-k] = conj(V[k]), so the tree carries only bins 0..N/2 (rfft layout).
# Per level the even bins of the doubled grid are pointwise products of the
# carried halves; the odd bins cost one irfft + two rffts per factor (the
# twisted sequence x*w_{2N}^j splits into the two real sequences x*cos and
# x*sin), ~25% fewer transform flops and half the pointwise/memory work of
# the generic complex path.
# ---------------------------------------------------------------------------


def _value_enter_real(p):
    """Real coefficients ``[..., n, 2, 2, N+1]`` -> half-grid values (V, t).

    V[..., k] = p(w_N^k) + aliased top coefficient for k = 0..N/2 (rfft
    layout); t is the (real) z^N coefficient."""
    n_coef = p.shape[-1]
    t = p[..., n_coef - 1]
    V = jnp.fft.rfft(p[..., : n_coef - 1], axis=-1) + t[..., None]
    return V, t


def _half_twiddle_real(n: int, rdt):
    """cos/sin of pi*j/n for j = 0..n-1 (device-computed)."""
    ang = jnp.arange(n, dtype=rdt) * (math.pi / n)
    return jnp.cos(ang), jnp.sin(ang)


def _value_odd_bins_real(V, t, tw_cos, tw_sin):
    """Odd-bin evaluations o[k] = p(w_{2N}^{2k+1}), k = 0..N/2-1.

    Same algebra as :func:`_value_odd_bins`, but the coefficients are real:
    x = irfft(V) recovers them with the aliased top coefficient folded in,
    and FFT_N(x * w_{2N}^j)[k] = rfft(x*cos)[k] - i rfft(x*sin)[k] for
    k <= N/2 — two real transforms instead of one complex one. Conjugate
    symmetry of the odd half (o[N-1-k] = conj(o[k])) makes k < N/2 enough."""
    n = 2 * (V.shape[-1] - 1)
    x = jnp.fft.irfft(V, n=n, axis=-1)
    oc = jnp.fft.rfft(x * tw_cos, axis=-1)[..., :-1]
    osn = jnp.fft.rfft(x * tw_sin, axis=-1)[..., :-1]
    return oc - 1j * osn - (2.0 * t)[..., None]


def _value_level_real(V, t, w, do_norm: bool):
    """One real-symmetric tree level: N/2+1 half-grids -> N+1 half-grids."""
    Va, Vb = V[..., 0::2, :, :, :], V[..., 1::2, :, :, :]
    ta, tb = t[..., 0::2, :, :], t[..., 1::2, :, :]
    n = 2 * (V.shape[-1] - 1)
    rdt = t.dtype
    tw_cos, tw_sin = _half_twiddle_real(n, rdt)
    even = _mat2x2_mul(Vb, Va)                       # bins 0, 2, .., 2N/2
    odd = _mat2x2_mul(_value_odd_bins_real(Vb, tb, tw_cos, tw_sin),
                      _value_odd_bins_real(Va, ta, tw_cos, tw_sin))
    # interleave: out[2m] = even[m] (m <= N/2), out[2m+1] = odd[m] (m < N/2)
    odd_p = jnp.concatenate(
        [odd, jnp.zeros(odd.shape[:-1] + (1,), dtype=odd.dtype)], axis=-1)
    V_out = jnp.stack([even, odd_p], axis=-1).reshape(
        even.shape[:-1] + (2 * (even.shape[-1]),))[..., : n + 1]
    t_out = _mat2x2_mul(tb[..., None], ta[..., None])[..., 0]
    if w is not None:
        w = w[..., 0::2] + w[..., 1::2]
    if do_norm:
        # uncarried bins are conjugates of carried ones: same magnitudes
        max_abs = jnp.maximum(
            jnp.max(jnp.abs(V_out), axis=(-3, -2, -1)),
            jnp.max(jnp.abs(t_out), axis=(-2, -1)))
        a_exp = _exp_from_max(max_abs)
        scale = jnp.ldexp(jnp.asarray(1.0, rdt), -a_exp)
        V_out = V_out * scale[..., None, None, None]
        t_out = t_out * scale[..., None, None]
        w = w + a_exp if w is not None else a_exp
    return V_out, t_out, w


def _value_exit_real(V, t, cdt, want=None):
    """Half-grid values -> complex coefficients ``[..., 2, 2, N+1]``.

    Entries outside ``want`` are zero; coefficients are mathematically
    real and cast to ``cdt`` for the downstream (complex) consumers."""
    n = 2 * (V.shape[-1] - 1)
    if want is None:
        want = ((0, 0), (0, 1), (1, 0), (1, 1))
    Vs = jnp.stack([V[..., i, j, :] for i, j in want], axis=-2)
    ts = jnp.stack([t[..., i, j] for i, j in want], axis=-1)
    qs = jnp.fft.irfft(Vs, n=n, axis=-1)
    qs = qs.at[..., 0].add(-ts)
    qs = jnp.concatenate([qs, ts[..., None]], axis=-1)
    out = jnp.zeros(V.shape[:-3] + (2, 2, n + 1), dtype=cdt)
    for k, (i, j) in enumerate(want):
        out = out.at[..., i, j, :].set(qs[..., k, :].astype(cdt))
    return out


def _want_mask(want) -> np.ndarray:
    """Boolean [2, 2, 1] mask selecting the ``want`` matrix entries
    (shared with the df64 tree, ops/df64_pipeline.py)."""
    mask = np.zeros((2, 2, 1), dtype=bool)
    for i, j in want:
        mask[i, j, 0] = True
    return mask


def _pad_to_power_of_2_2x2(p):
    """Pad a matrix stack with identity (constant-1 polynomial) matrices."""
    n = p.shape[-4]
    n_pad = next_power_of_2(n)
    if n_pad == n:
        return p, 0
    eye = jnp.zeros(p.shape[:-4] + (n_pad - n, 2, 2, p.shape[-1]), dtype=p.dtype)
    eye = eye.at[..., 0, 0, 0].set(1.0).at[..., 1, 1, 0].set(1.0)
    return jnp.concatenate([p, eye], axis=-4), n_pad - n


def fmult2x2_tree(p, *, normalize: bool = True, want=None,
                  jsym: int | None = None, rsym: bool = False):
    """Multiply a stack of 2x2 polynomial matrices via a log-depth FFT tree.

    Args:
      p: ``[..., n, 2, 2, deg+1]`` ascending coefficients, natural time order.
      normalize: per-product power-of-two rescaling (returns exponent ``w``).
      want: optional tuple of (row, col) entries of the final matrix the
        caller will read; the remaining entries of the result are zero.
        Saves final-size inverse transforms on the value-space path.
      jsym: +1/-1 asserts the J-involution symmetry P22 = rev(conj(P11)),
        P12 = -jsym*rev(conj(P21)) of every input matrix (AKNS with
        r = -jsym*conj(q); holds for all NSE fast schemes).  The
        value-space levels then carry only the first matrix column —
        half the FFT work and memory.  Requires n to be a power of two
        (identity padding breaks the symmetry); silently falls back to
        the generic path otherwise.
      rsym: asserts every input coefficient is real (KdV: r = -1 with a
        real potential; closed under products).  The value-space levels
        then carry conjugate-symmetric half grids (rfft layout) — ~25%
        fewer transform flops and half the pointwise/memory work.  The
        result is still returned in the complex dtype of ``p``.
        Takes precedence over ``jsym``.

    Returns:
      (result, w): ``result[..., 2, 2, n*deg+1]`` and int32 ``w`` with
      ``true_result = result * 2**w`` (w == 0 array when normalize=False).

    Complexity O(n deg log^2(n deg)); every level is one batched FFT +
    pointwise complex matmul — no sequential per-sample work.
    """
    n = p.shape[-4]
    deg_in = p.shape[-1] - 1
    cdt_in = complex_dtype_of(p)
    p, _ = _pad_to_power_of_2_2x2(p)
    if rsym:
        # real-coefficient contract: drop the (zero) imaginary parts so the
        # direct-convolution levels run in real arithmetic too
        p = jnp.real(p)
    n_pad = p.shape[-4]
    levels = int(math.log2(n_pad)) if n_pad > 1 else 0

    w = jnp.zeros(p.shape[:-4] + (n_pad,), dtype=jnp.int32) \
        if normalize else None

    def _do_norm(lv):
        # rescale every other level (and always the last): two levels of
        # near-unitary products cannot overflow, and each skipped rescale
        # saves two full passes over the coefficient array
        return normalize and (lv % 2 == 1 or lv == levels - 1)

    lv = 0
    # tiny degrees: direct convolution beats any FFT
    while lv < levels and p.shape[-1] <= _conv_cutoff():
        with jax.named_scope(f"fmult_level_{lv}"):
            p, w = _tree_level_2x2(p, w, _do_norm(lv))
        lv += 1
    if _value_tree_enabled() and levels - lv >= 2:
        if rsym and (p.shape[-1] - 1) % 2 == 0:
            V, t = _value_enter_real(p)
            while lv < levels:
                V, t, w = _value_level_real(V, t, w, _do_norm(lv))
                lv += 1
            p = _value_exit_real(V, t, cdt_in, want=want)
        elif jsym in (1, -1) and n == n_pad and not rsym:
            Vc, tc, cc = _value_enter_sym(p)
            while lv < levels:
                Vc, tc, cc, w = _value_level_sym(Vc, tc, cc, w, jsym,
                                                 _do_norm(lv))
                lv += 1
            p = _value_exit_sym(Vc, tc, cc, jsym, want=want)
        else:
            V, t = _value_enter(p)
            while lv < levels:
                V, t, w = _value_level(V, t, w, _do_norm(lv))
                lv += 1
            p = _value_exit(V, t, want=want)
    else:
        while lv < levels:
            p, w = _tree_level_2x2(p, w, _do_norm(lv))
            lv += 1
        if want is not None:
            p = jnp.where(jnp.asarray(_want_mask(want)), p, 0.0)
    result = p[..., 0, :, :, :]
    # identity padding contributes degree 0; true degree is n*deg_in
    result = result[..., : n * deg_in + 1]
    if rsym and not jnp.iscomplexobj(result):
        # fallback paths may have stayed in real arithmetic end-to-end
        result = result.astype(cdt_in)
    if w is None:
        w_out = jnp.zeros(result.shape[:-3], dtype=jnp.int32)
    else:
        w_out = w[..., 0]
    return result, w_out


def fmult2x2(p, *, normalize: bool = True):
    """Alias of :func:`fmult2x2_tree` (reference name: poly_fmult2x2)."""
    return fmult2x2_tree(p, normalize=normalize)


def fmult(p, *, normalize: bool = True):
    """Scalar version: multiply ``[..., n, deg+1]`` polynomials.

    Returns (result ``[..., n*deg+1]``, w) with the same normalization
    semantics as :func:`fmult2x2_tree` (reference: poly_fmult).
    """
    n = p.shape[-2]
    deg_in = p.shape[-1] - 1
    n_pad = next_power_of_2(n)
    if n_pad != n:
        ones = jnp.zeros(p.shape[:-2] + (n_pad - n, p.shape[-1]), dtype=p.dtype)
        ones = ones.at[..., 0].set(1.0)
        p = jnp.concatenate([p, ones], axis=-2)
    w = jnp.zeros(p.shape[:-1], dtype=jnp.int32) if normalize else None
    levels = int(math.log2(n_pad)) if n_pad > 1 else 0
    for _ in range(levels):
        c = p.shape[-1]
        length = next_fft_length(2 * c - 1)
        fa = jnp.fft.fft(p[..., 0::2, :], n=length, axis=-1)
        fb = jnp.fft.fft(p[..., 1::2, :], n=length, axis=-1)
        prod = jnp.fft.ifft(fa * fb, axis=-1)[..., : 2 * c - 1].astype(p.dtype)
        if w is not None:
            w = w[..., 0::2] + w[..., 1::2]
            a_exp = _rescale_exponents(prod, axes=(-1,))
            prod = prod * jnp.ldexp(
                jnp.asarray(1.0, jnp.real(prod).dtype), -a_exp)[..., None]
            w = w + a_exp
        p = prod
    result = p[..., 0, : n * deg_in + 1]
    w_out = w[..., 0] if w is not None else jnp.zeros(result.shape[:-1], jnp.int32)
    return result, w_out


# ---------------------------------------------------------------------------
# Chirp-Z transform
# ---------------------------------------------------------------------------

def _spiral_table(base: complex, exponents: np.ndarray) -> np.ndarray:
    """base**exponents computed in extended precision on the host.

    ``base`` and the exponent grid are static (they come from the spectral
    grid geometry), so the chirp tables are embedded as constants. Extended
    precision matters because exponents grow like deg^2/2.
    """
    log_mag = np.log(np.abs(base)) if abs(base) != 1.0 else 0.0
    theta = np.longdouble(math.atan2(base.imag, base.real))
    e = exponents.astype(np.longdouble)
    phase = np.mod(e * theta, np.longdouble(2 * math.pi))
    mag = np.exp(e * np.longdouble(log_mag)) if log_mag != 0.0 else 1.0
    return (mag * (np.cos(phase.astype(np.float64))
                   + 1j * np.sin(phase.astype(np.float64)))).astype(np.complex128)


@partial(jax.jit, static_argnames=("a", "w", "m"))
def chirpz(coeffs, a: complex, w: complex, m: int):
    """Evaluate p(z) at the spiral points ``z_k = a * w**k``, k = 0..m-1.

    Bluestein/Rader factorization nm = (n^2 + m^2 - (n-m)^2)/2 turns the
    evaluation into one circular convolution (3 FFTs). ``a`` and ``w`` are
    static Python complex numbers (grid geometry); ``coeffs`` is traced and
    may have leading batch dimensions.

    Reference: fnft__poly_chirpz.c:33-105 (Rabiner/Schafer/Rader), with the
    coefficient-order convention flipped to ascending.
    """
    coeffs = jnp.asarray(coeffs)
    cdt = complex_dtype_of(coeffs)
    n = coeffs.shape[-1]
    length = next_fft_length(n + m - 1)

    ks = np.arange(max(n, m), dtype=np.float64)
    w_half_sq = _spiral_table(complex(w), 0.5 * ks * ks)         # w^{k^2/2}
    a_pow = _spiral_table(complex(a), ks[:n])                    # a^n

    x_weight = jnp.asarray((a_pow * w_half_sq[:n]), dtype=cdt)
    x = coeffs.astype(cdt) * x_weight

    # v_j = w^{-j^2/2} for j = -(n-1) .. (m-1), laid out circularly
    v = np.zeros(length, dtype=np.complex128)
    v[:m] = 1.0 / w_half_sq[:m]
    neg = _spiral_table(complex(w), 0.5 * ks[1:n] * ks[1:n])
    v[length - n + 1:] = (1.0 / neg)[::-1]
    v_f = jnp.asarray(np.fft.fft(v), dtype=cdt)

    conv = jnp.fft.ifft(jnp.fft.fft(x, n=length, axis=-1) * v_f, axis=-1)
    out = conv[..., :m] * jnp.asarray(w_half_sq[:m], dtype=cdt)
    return out.astype(cdt)


# ---------------------------------------------------------------------------
# Horner evaluation
# ---------------------------------------------------------------------------

def poly_eval(coeffs, z):
    """Evaluate p at points z (ascending coefficients; Horner via lax.scan).

    For |z| > 1 the reversed-Horner form p(z) = z^deg q(1/z) is used for
    stability (reference: fnft__poly_eval.c:25-91).
    """
    p, _ = poly_evalderiv(coeffs, z, with_derivative=False)
    return p


def poly_evalderiv(coeffs, z, *, with_derivative: bool = True):
    """Evaluate (p(z), p'(z)) at a vector of points."""
    coeffs = jnp.asarray(coeffs)
    z = jnp.asarray(z)
    cdt = jnp.promote_types(complex_dtype_of(coeffs), complex_dtype_of(z))
    coeffs = coeffs.astype(cdt)
    z = z.astype(cdt)
    deg = coeffs.shape[-1] - 1

    inside = jnp.abs(z) <= 1.0
    z_safe = jnp.where(inside, z, 1.0 / jnp.where(z == 0, 1.0, z))

    def horner(cs, x):
        # scan from the highest coefficient downward, tracking p and p'
        def step(carry, ck):
            pv, dv = carry
            dv = dv * x + pv
            pv = pv * x + ck
            return (pv, dv), None

        init = (jnp.zeros_like(x), jnp.zeros_like(x))
        (pv, dv), _ = jax.lax.scan(step, init, cs[::-1])
        return pv, dv

    p_in, dp_in = horner(coeffs, z_safe)          # valid when |z| <= 1
    p_rev, dp_rev = horner(coeffs[::-1], z_safe)  # q(1/z), q'(1/z)

    zdeg = jnp.where(inside, 1.0, z) ** deg
    p_out = zdeg * p_rev
    p = jnp.where(inside, p_in, p_out)
    if not with_derivative:
        return p, None
    # p'(z) = deg z^{deg-1} q(1/z) - z^{deg-2} q'(1/z) for the reversed form
    zdeg1 = jnp.where(inside, 1.0, z) ** (deg - 1)
    zdeg2 = jnp.where(inside, 1.0, z) ** (deg - 2)
    dp_out = deg * zdeg1 * p_rev - zdeg2 * dp_rev
    dp = jnp.where(inside, dp_in, dp_out)
    return p, dp
