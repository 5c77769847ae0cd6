"""Double-float (df64) arithmetic: ~double precision from float32 pairs.

For devices without float64 ALUs. A df64 value represents x = hi + lo with
|lo| <= ulp(hi)/2, giving ~49 bits of mantissa from two float32s — enough
to push the fmult tree / chirp-Z roundoff from ~1e-6 to ~1e-12 in float32
arithmetic only.

Algorithms: Knuth two-sum, Dekker split/two-prod (Veltkamp splitting; no
FMA assumption), add22/mul22 (Dekker 1971, Bailey's ddfun conventions).
Complex df64 values are (re, im) pairs of df64 pairs. The FFT is an
iterative radix-2 Stockham over df64 complex arrays with twiddles
precomputed in float64 on the host and split into hi/lo planes.

Used by :func:`fmult2x2_tree_df64` (high-precision polynomial matrix
products) — see docs/performance.md for the precision story.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_SPLITTER = 4097.0  # 2^12 + 1 for float32 Veltkamp splitting


# ---------------------------------------------------------------------------
# real df64 primitives (each value is a (hi, lo) pair of float32 arrays)
# ---------------------------------------------------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    c = _SPLITTER * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def df_from_f64(x):
    """Split float64 (or complex128 handled by caller) into float32 pairs."""
    hi = x.astype(jnp.float32) if hasattr(x, "astype") else np.float32(x)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return hi, lo


def df_to_f64(x):
    hi, lo = x
    return hi.astype(jnp.float64) + lo.astype(jnp.float64)


def _df_align(x, y):
    """Materialize shape/batching broadcasts before the EFT sequences.

    XLA:CPU produces wrong low-order parts when the Dekker/Knuth chains
    mix a vmap-batched operand with an unbatched (broadcast_in_dim) one —
    jit(vmap(df_mul, in_axes=(0, None))) degrades to plain f32 while the
    pre-broadcast form is exact (measured; see tests/test_df64.py).
    Adding an exact zero of the joint shape forces both operands onto the
    same (batched) layout without changing any value.
    """
    z = x[0] * 0 + y[0] * 0
    return (x[0] + z, x[1] + z), (y[0] + z, y[1] + z)


def df_add(x, y):
    x, y = _df_align(x, y)
    xh, xl = x
    yh, yl = y
    s, e = _two_sum(xh, yh)
    e = e + (xl + yl)
    return _quick_two_sum(s, e)


def df_neg(x):
    return (-x[0], -x[1])


def df_sub(x, y):
    return df_add(x, df_neg(y))


def df_mul(x, y):
    x, y = _df_align(x, y)
    xh, xl = x
    yh, yl = y
    p, e = _two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return _quick_two_sum(p, e)


def df_rsqrt(x):
    """1/sqrt(x) for positive real df pairs: f32 estimate + two
    division-free Newton steps s <- s (3 - x s^2) / 2 in df arithmetic."""
    s0 = jax.lax.rsqrt(jnp.maximum(x[0], jnp.finfo(jnp.float32).tiny))
    s = (s0, jnp.zeros_like(s0))
    half = (jnp.full_like(s0, 0.5), jnp.zeros_like(s0))
    three = (jnp.full_like(s0, 3.0), jnp.zeros_like(s0))
    for _ in range(2):
        xs2 = df_mul(x, df_mul(s, s))
        s = df_mul(df_mul(s, df_sub(three, xs2)), half)
    return s


# ---------------------------------------------------------------------------
# complex df64: ((re_hi, re_lo), (im_hi, im_lo))
# ---------------------------------------------------------------------------

def _split_host_complex(zn: np.ndarray):
    """Error-free float32 hi/lo split of a host complex128 array.

    Pure numpy float64 arithmetic, so the split is exact even when jax
    x64 is off (the float32 mode), where a device-side split would
    first truncate to complex64 and zero out every lo plane."""
    re, im = np.real(zn), np.imag(zn)
    re_hi = re.astype(np.float32)
    re_lo = (re - re_hi.astype(np.float64)).astype(np.float32)
    im_hi = im.astype(np.float32)
    im_lo = (im - im_hi.astype(np.float64)).astype(np.float32)
    return ((jnp.asarray(re_hi), jnp.asarray(re_lo)),
            (jnp.asarray(im_hi), jnp.asarray(im_lo)))


def cdf_from_c128(z):
    if not isinstance(z, jax.Array):
        return _split_host_complex(np.asarray(z, dtype=np.complex128))
    z = jnp.asarray(z)
    re = jnp.real(z)
    im = jnp.imag(z)
    return (df_from_f64(re), df_from_f64(im))


def cdf_to_c128(z):
    re, im = z
    if isinstance(re[0], jax.Array) and not isinstance(re[0], jax.core.Tracer):
        # join on the host: exact even when jax x64 is off
        def join(x):
            return (np.asarray(x[0], dtype=np.float64)
                    + np.asarray(x[1], dtype=np.float64))
        return join(re) + 1j * join(im)
    return df_to_f64(re) + 1j * df_to_f64(im)


def cdf_add(x, y):
    return (df_add(x[0], y[0]), df_add(x[1], y[1]))


def cdf_sub(x, y):
    return (df_sub(x[0], y[0]), df_sub(x[1], y[1]))


def cdf_mul(x, y):
    xr, xi = x
    yr, yi = y
    re = df_sub(df_mul(xr, yr), df_mul(xi, yi))
    im = df_add(df_mul(xr, yi), df_mul(xi, yr))
    return (re, im)


def cdf_div(x, y):
    """Complex df64 quotient: f32 Smith-style estimate + two cdf residual
    corrections (classic double-double division refinement)."""
    def approx_div(nr, ni, yr, yi):
        den = yr * yr + yi * yi
        den = jnp.where(den == 0, 1.0, den)
        return (nr * yr + ni * yi) / den, (ni * yr - nr * yi) / den

    def as_cdf(qr, qi):
        z = jnp.zeros_like(qr)
        return ((qr, z), (qi, z))

    q1 = as_cdf(*approx_div(x[0][0], x[1][0], y[0][0], y[1][0]))
    r1 = cdf_sub(x, cdf_mul(q1, y))
    q2 = as_cdf(*approx_div(r1[0][0], r1[1][0], y[0][0], y[1][0]))
    r2 = cdf_sub(r1, cdf_mul(q2, y))
    q3 = as_cdf(*approx_div(r2[0][0], r2[1][0], y[0][0], y[1][0]))
    return cdf_add(cdf_add(q1, q2), q3)


def _cdf_stack(parts, axis=0):
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=axis), *parts)


def _cdf_index(z, idx):
    return jax.tree.map(lambda a: a[idx], z)


def _cdf_zeros_like(z, shape=None):
    def f(a):
        return jnp.zeros(shape if shape is not None else a.shape, a.dtype)
    return jax.tree.map(f, z)


# ---------------------------------------------------------------------------
# radix-2 Stockham FFT in df64
# ---------------------------------------------------------------------------

_CDF_REG_HOST_CACHE: dict = {}


def _cdf_reg(key: tuple, builder_c128):
    """Host complex128 table -> cdf constant, through the table registry.

    Under :func:`fnft_tpu.ops.tables.jit_tabled` the four hi/lo planes are
    passed as jit parameters instead of being inlined as literals — the
    df64 pipeline's twiddle/chirp-Z tables total hundreds of MB of MLIR at
    D=2^20 otherwise (same failure mode ops/tpu_pipeline.py hit).  Host
    planes are memoized per key (builders are deterministic per key)."""
    from fnft_tpu.ops import tables

    def build():
        cached = _CDF_REG_HOST_CACHE.get(key)
        if cached is not None:
            return cached
        z = np.asarray(builder_c128(), dtype=np.complex128)
        re, im = np.real(z), np.imag(z)
        rh = re.astype(np.float32)
        rl = (re - rh.astype(np.float64)).astype(np.float32)
        ih = im.astype(np.float32)
        il = (im - ih.astype(np.float64)).astype(np.float32)
        planes = (rh, rl, ih, il)
        if sum(p.nbytes for p in planes) <= (1 << 24):  # cap at 16 MB/key
            _CDF_REG_HOST_CACHE[key] = planes
        return planes

    rh, rl, ih, il = tables.get(key, build)
    return ((rh, rl), (ih, il))


def _twiddles(length: int, sign: int):
    """Host-precomputed df64 twiddle planes for each stage."""
    half = length // 2
    return _cdf_reg(("df64_tw", length, sign),
                    lambda: np.exp(sign * 2j * np.pi
                                   * np.arange(half) / length))


def _bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


_FFT_LOOP_THRESHOLD = 4  # lengths above this use the fori_loop body
# (the unrolled form traces O(n log n) ops per distinct length; with ~10
# distinct lengths per df64 tree the loop form cuts whole-pipeline XLA
# compile from ~55 s to ~20 s at D=1024 and runs faster as well)

_FFT_FOUR_STEP_THRESHOLD = 256  # lengths >= this use the four-step path


def _fft_unrolled_last(x, n: int, sign: int):
    """Unrolled radix-2 DIT along the last axis (no 1/n normalization).

    One bit-reversal gather, then log2(n) reshape-based butterfly stages
    (pure slices/concats — no index-computed gathers). Only used for the
    four-step sub-lengths (<= ~2^10), so the traced op count stays small.
    """
    perm = jnp.asarray(_bit_reverse_indices(n))
    x = jax.tree.map(lambda t: t[..., perm], x)
    m = 1
    while m < n:
        blocks = n // (2 * m)

        def reshaped(t):
            return t.reshape(t.shape[:-1] + (blocks, 2, m))

        xr = jax.tree.map(reshaped, x)
        a = _cdf_index(xr, (Ellipsis, 0, slice(None)))
        b = _cdf_index(xr, (Ellipsis, 1, slice(None)))
        tw = _twiddles(2 * m, sign)  # w^j, j in [0, m)
        t_ = cdf_mul(b, tw)
        lo = cdf_add(a, t_)
        hi = cdf_sub(a, t_)
        x = jax.tree.map(
            lambda l, h: jnp.stack([l, h], axis=-2).reshape(
                l.shape[:-2] + (n,)),
            lo, hi)
        m *= 2
    return x


def _four_step_twiddle(n1: int, n2: int, sign: int):
    """df64 twiddle plane T[j2, k1] = w_n^{j2 k1}, host-precomputed."""
    def build():
        j2 = np.arange(n2)[:, None]
        k1 = np.arange(n1)[None, :]
        return np.exp(sign * 2j * np.pi * (j2 * k1) / (n1 * n2))

    return _cdf_reg(("df64_tw4", n1, n2, sign), build)


def _radix3_twiddles(n: int, sign: int):
    """Host df64 twiddle planes w^k and w^{2k}, k in [0, n)."""
    k = np.arange(n)
    return [_cdf_reg(("df64_tw3", n, sign, mult),
                     lambda mult=mult: np.exp(
                         sign * 2j * np.pi * (mult * k % n) / n))
            for mult in (1, 2)]


def _fft_radix3_split(x, n: int, sign: int):
    """DIT 3-way split for n = 3 * 2^k: three power-of-two sub-FFTs plus
    one twiddled combine. Lets the df64 tree use 3*2^k lengths instead of
    padding all the way to the next power of two (up to 25% less work)."""
    m = n // 3
    x0 = jax.tree.map(lambda t: t[..., 0::3], x)
    x1 = jax.tree.map(lambda t: t[..., 1::3], x)
    x2 = jax.tree.map(lambda t: t[..., 2::3], x)
    f0 = _fft_pow2(x0, m, sign)
    f1 = _fft_pow2(x1, m, sign)
    f2 = _fft_pow2(x2, m, sign)
    w1, w2 = _radix3_twiddles(n, sign)

    def tile3(z):
        return jax.tree.map(
            lambda t: jnp.concatenate([t, t, t], axis=-1), z)

    t1 = cdf_mul(tile3(f1), w1)
    t2 = cdf_mul(tile3(f2), w2)
    return cdf_add(cdf_add(tile3(f0), t1), t2)


def _fft_pow2(x, n: int, sign: int):
    """Power-of-two FFT along the last axis, no normalization."""
    if n >= _FFT_FOUR_STEP_THRESHOLD:
        return _fft_four_step(x, n, sign)
    return _fft_unrolled_last(x, n, sign)


def _fft_four_step(x, n: int, sign: int):
    """Bailey four-step FFT: n = n1*n2, two batched sub-FFTs + twiddle.

    X[k2 n1 + k1] = sum_j2 [ (sum_j1 x[j1 n2 + j2] W_n1^{j1 k1})
                             * w^{j2 k1} ] W_n2^{j2 k2}

    Everything is reshapes/transposes plus unrolled sub-FFTs over a
    batched axis — no index-computed gathers, so it vectorizes.
    """
    n1 = 1 << (n.bit_length() - 1) // 2
    n2 = n // n1
    tw = _four_step_twiddle(n1, n2, sign)
    # [..., n] -> [..., n1, n2] (j1 major) -> [..., n2, n1]
    y = jax.tree.map(lambda t: t.reshape(t.shape[:-1] + (n1, n2))
                     .swapaxes(-1, -2), x)
    y = _fft_unrolled_last(y, n1, sign)          # A[..., j2, k1]
    y = cdf_mul(y, tw)                           # * w^{j2 k1}
    y = jax.tree.map(lambda t: t.swapaxes(-1, -2), y)  # [..., k1, j2]
    y = _fft_unrolled_last(y, n2, sign)          # B[..., k1, k2]
    return jax.tree.map(
        lambda t: t.swapaxes(-1, -2).reshape(t.shape[:-2] + (n,)), y)


def _fft_df64(z, length: int, *, inverse: bool = False):
    """FFT along the last axis of a df64 complex array (power-of-2 length).

    Radix-2 DIT: one bit-reversal gather plus butterfly stages. Small
    lengths unroll the stages (best XLA fusion); large lengths run the
    stages in a ``lax.fori_loop`` with index-computed partners and
    twiddles, keeping the traced graph O(1) per FFT length — essential
    because the df64 tree instantiates many lengths per program.
    ``z`` is ((re_hi, re_lo), (im_hi, im_lo)), trailing axis already
    padded to ``length``.
    """
    sign = 1 if inverse else -1
    n = length

    if n % 3 == 0 and (n // 3) & (n // 3 - 1) == 0:
        out = _fft_radix3_split(z, n, sign)
        if inverse:
            # 1/n is NOT a power of two here: a per-plane scale would
            # corrupt the hi/lo invariant — do a df64 real multiply
            inv_hi = np.float32(1.0 / n)
            inv_lo = np.float32(1.0 / n - np.float64(inv_hi))
            out = jax.tree.map(
                lambda pair: df_mul(pair, (jnp.asarray(inv_hi),
                                           jnp.asarray(inv_lo))),
                out, is_leaf=lambda p: isinstance(p, tuple)
                and len(p) == 2 and not isinstance(p[0], tuple))
        return out

    assert length & (length - 1) == 0, \
        f"df64 FFT lengths must be 2^a or 3*2^a, got {length}"

    if n >= _FFT_FOUR_STEP_THRESHOLD:
        out = _fft_four_step(z, n, sign)
        if inverse:
            inv_n = 1.0 / n
            out = jax.tree.map(lambda t: t * inv_n, out)
        return out

    perm = jnp.asarray(_bit_reverse_indices(n))
    x = jax.tree.map(lambda t: t[..., perm], z)

    if n <= _FFT_LOOP_THRESHOLD:
        m = 1
        while m < n:
            blocks = n // (2 * m)

            def reshaped(t):
                return t.reshape(t.shape[:-1] + (blocks, 2, m))

            xr = jax.tree.map(reshaped, x)
            a = _cdf_index(xr, (Ellipsis, 0, slice(None)))
            b = _cdf_index(xr, (Ellipsis, 1, slice(None)))
            tw = _twiddles(2 * m, sign)  # w^j, j in [0, m)
            t_ = cdf_mul(b, tw)
            lo = cdf_add(a, t_)
            hi = cdf_sub(a, t_)
            x = jax.tree.map(
                lambda l, h: jnp.stack([l, h], axis=-2).reshape(
                    l.shape[:-2] + (n,)),
                lo, hi)
            m *= 2
        out = x
    else:
        # full-length twiddle table w^k, k in [0, n/2); stage s uses
        # entries (i mod m) * (n/(2m)) with m = 2^s
        tw_full = _twiddles(n, sign)
        stages = n.bit_length() - 1
        idx = jnp.arange(n)

        def stage(s, xs):
            m = jnp.int32(1) << s
            grp = idx & (m - 1)              # position within the half-block
            is_hi = (idx & m) != 0
            partner = jnp.where(is_hi, idx - m, idx + m)
            # (n//2)//m first: grp * (n//2) overflows int32 for n >= 2^17
            # (x64-off mode); m = 2^s always divides n//2 so this is exact
            tw_idx = grp * ((n // 2) // m)
            twr = (tw_full[0][0][tw_idx], tw_full[0][1][tw_idx])
            twi = (tw_full[1][0][tw_idx], tw_full[1][1][tw_idx])
            a = jax.tree.map(lambda t: jnp.where(
                is_hi, t[..., partner], t), xs)          # lower element
            b = jax.tree.map(lambda t: jnp.where(
                is_hi, t, t[..., partner]), xs)          # upper element
            t_ = cdf_mul(b, (twr, twi))
            lo = cdf_add(a, t_)
            hi = cdf_sub(a, t_)
            return jax.tree.map(
                lambda l, h: jnp.where(is_hi, h, l), lo, hi)

        out = jax.lax.fori_loop(0, stages, stage, x)
    if inverse:
        inv_n = 1.0 / n
        out = jax.tree.map(lambda t: t * inv_n, out)
    return out


@partial(jax.jit, static_argnames=("length", "inverse"))
def fft_df64(z, length: int, *, inverse: bool = False):
    """Jitted entry point of :func:`_fft_df64` (the public API).

    Internal df64 tree/chirp-Z code calls ``_fft_df64`` directly so the
    whole stage is one program — nesting this jit inside
    ``tables.jit_tabled`` would capture table tracers across the jit
    boundary."""
    return _fft_df64(z, length, inverse=inverse)


def next_fft_length_df64(x: int) -> int:
    """Smallest supported df64 FFT length >= x (2^a or 3*2^a)."""
    if x <= 1:
        return 1
    p2 = 1 << (x - 1).bit_length()
    third = (x + 2) // 3  # ceil(x/3)
    p3 = 3 * (1 << (third - 1).bit_length() if third > 1 else 1)
    assert p3 >= x
    return min(p2, p3)


def _pad_last(z, length):
    def f(t):
        pad = [(0, 0)] * (t.ndim - 1) + [(0, length - t.shape[-1])]
        return jnp.pad(t, pad)
    return jax.tree.map(f, z)


# ---------------------------------------------------------------------------
# high-precision polynomial matrix tree
#
# Past the small-degree levels the tree can switch to the value-space
# representation of ops/poly (nodes carried as evaluations at the N-th
# roots of unity plus the z^N coefficient as an exact side channel); the
# helpers below are the df64 counterparts of poly._value_enter /
# _value_odd_bins / _value_level / _value_exit.  Grids are exact df64 FFT
# lengths (2^a or 3*2^a): 16 size-N transforms per pair replace the 12
# transforms of length ~2.05N of the padded coefficient product — ~35%
# less FFT work in the dominant df64 stage.
# ---------------------------------------------------------------------------

def _cdf_table(z128):
    """Host complex128 table -> cdf constant (error-free split)."""
    return cdf_from_c128(np.asarray(z128, dtype=np.complex128))


def _value_enter_df64(p, n: int):
    """cdf coeffs [..., n+1] -> (V on the n-grid, top coeff t)."""
    t = _cdf_index(p, (Ellipsis, n))
    V = _fft_df64(_cdf_index(p, (Ellipsis, slice(0, n))), n)
    V = cdf_add(V, jax.tree.map(lambda x: x[..., None], t))
    return V, t


def _value_odd_df64(V, t, tw, n: int):
    """Evaluations at the odd points of the 2n grid (see poly._value_odd_bins)."""
    q = _fft_df64(V, n, inverse=True)
    o = _fft_df64(cdf_mul(q, tw), n)
    # subtract 2t (exact per-plane scale by 2)
    t2 = jax.tree.map(lambda x: 2.0 * x[..., None], t)
    return cdf_sub(o, t2)


def _cdf_mat2x2_mul(b, a):
    """(b @ a) over cdf [..., 2, 2, L] stacks, elementwise on L."""
    def e(z, i, j):
        return _cdf_index(z, (Ellipsis, i, j, slice(None)))

    rows = []
    for i in range(2):
        cols = []
        for j in range(2):
            cols.append(cdf_add(cdf_mul(e(b, i, 0), e(a, 0, j)),
                                cdf_mul(e(b, i, 1), e(a, 1, j))))
        rows.append(_cdf_stack(cols, axis=-2))
    return _cdf_stack(rows, axis=-3)


def _value_level_df64(V, t, n: int):
    """One tree level in value space: n-grid pairs -> 2n-grid products.

    Pairs along axis -4 of the [..., pairs, 2, 2, n] layout (matching the
    coefficient tree).  Returns (V_out, t_out) un-rescaled; the caller
    owns the 2^w bookkeeping.
    """
    sl_a = (Ellipsis, slice(0, None, 2), slice(None), slice(None), slice(None))
    sl_b = (Ellipsis, slice(1, None, 2), slice(None), slice(None), slice(None))
    Va, Vb = _cdf_index(V, sl_a), _cdf_index(V, sl_b)
    ta = _cdf_index(t, (Ellipsis, slice(0, None, 2), slice(None), slice(None)))
    tb = _cdf_index(t, (Ellipsis, slice(1, None, 2), slice(None), slice(None)))
    tw = _cdf_reg(("df64_half_tw", n),
                  lambda: np.exp(-1j * np.pi * np.arange(n) / n))
    even = _cdf_mat2x2_mul(Vb, Va)
    odd = _cdf_mat2x2_mul(_value_odd_df64(Vb, tb, tw, n),
                          _value_odd_df64(Va, ta, tw, n))
    V_out = jax.tree.map(
        lambda ev, od: jnp.stack([ev, od], axis=-1).reshape(
            ev.shape[:-1] + (2 * n,)), even, odd)
    t_mat = _cdf_mat2x2_mul(jax.tree.map(lambda x: x[..., None], tb),
                            jax.tree.map(lambda x: x[..., None], ta))
    t_out = _cdf_index(t_mat, (Ellipsis, 0))
    return V_out, t_out


def _value_exit_df64(V, t, n: int, want=None):
    """(V, t) on the n grid -> cdf coefficients [..., n+1].

    With ``want`` only those (row, col) entries are inverse-transformed;
    the others are zero (poly._value_exit semantics)."""
    if want is not None:
        Vs = _cdf_stack([_cdf_index(V, (Ellipsis, i, j, slice(None)))
                         for i, j in want], axis=-2)
        ts = _cdf_stack([_cdf_index(t, (Ellipsis, i, j))
                         for i, j in want], axis=-1)
        qs = _fft_df64(Vs, n, inverse=True)
        q0 = cdf_sub(_cdf_index(qs, (Ellipsis, 0)), ts)
        qs = jax.tree.map(lambda qp, cp: qp.at[..., 0].set(cp), qs, q0)
        qs = jax.tree.map(lambda qp, tp: jnp.concatenate(
            [qp, tp[..., None]], axis=-1), qs, ts)
        out = _cdf_zeros_like(V, shape=V[0][0].shape[:-1] + (n + 1,))
        for k, (i, j) in enumerate(want):
            sel = _cdf_index(qs, (Ellipsis, k, slice(None)))
            out = jax.tree.map(
                lambda op, sp, i=i, j=j: op.at[..., i, j, :].set(sp),
                out, sel)
        return out
    q = _fft_df64(V, n, inverse=True)
    q0 = cdf_sub(_cdf_index(q, (Ellipsis, 0)), t)
    q = jax.tree.map(lambda qp, cp: qp.at[..., 0].set(cp), q, q0)
    return jax.tree.map(lambda qp, tp: jnp.concatenate(
        [qp, tp[..., None]], axis=-1), q, t)


def value_grid_supported_df64(n: int) -> bool:
    """Is n an exact df64 FFT length (2^a or 3*2^a) of useful size?"""
    return n >= 16 and next_fft_length_df64(n) == n


# ---------------------------------------------------------------------------
# J-symmetric df64 value levels (see ops/poly.py's _value_level_sym): for
# AKNS nodes with r = -kappa conj(q) only the first matrix column is
# carried; the grid size equals the nominal degree, so the missing column
# is +conj (even bins) / -conj (odd bins) of the carried one, and the
# scalar side channels (top/zeroth coefficients) close under the product.
# Halves the df64 FFT work of the dominant tree stage.
# ---------------------------------------------------------------------------

def _cdf_conj(z):
    re, im = z
    return (re, (-im[0], -im[1]))


def _cdf_neg(z):
    re, im = z
    return ((-re[0], -re[1]), (-im[0], -im[1]))


def _kscale(z, s: int):
    """z * s for s in {+1, -1} (static)."""
    return z if s == 1 else _cdf_neg(z)


def _value_enter_sym_df64(p, n: int):
    """cdf coeffs [..., n_mat, 2, 2, n+1] -> column state (Vc, tc, cc)."""
    col = _cdf_index(p, (Ellipsis, slice(None), 0, slice(None)))
    tc = _cdf_index(col, (Ellipsis, n))
    cc = _cdf_index(col, (Ellipsis, 0))
    Vc = _fft_df64(_cdf_index(col, (Ellipsis, slice(0, n))), n)
    Vc = cdf_add(Vc, jax.tree.map(lambda x: x[..., None], tc))
    return Vc, tc, cc


def _value_level_sym_df64(Vc, tc, cc, kappa: int, n: int):
    """One J-symmetric df64 tree level: n-grid column pairs -> 2n grid.

    Vc: [..., pairs, 2, n] cdf; tc/cc: [..., pairs, 2] cdf. Returns the
    un-rescaled products; the caller owns the 2^w bookkeeping."""
    sl_a = (Ellipsis, slice(0, None, 2), slice(None), slice(None))
    sl_b = (Ellipsis, slice(1, None, 2), slice(None), slice(None))
    Va, Vb = _cdf_index(Vc, sl_a), _cdf_index(Vc, sl_b)
    ta = _cdf_index(tc, (Ellipsis, slice(0, None, 2), slice(None)))
    tb = _cdf_index(tc, (Ellipsis, slice(1, None, 2), slice(None)))
    ca = _cdf_index(cc, (Ellipsis, slice(0, None, 2), slice(None)))
    cb = _cdf_index(cc, (Ellipsis, slice(1, None, 2), slice(None)))

    def ent(z, k):
        return _cdf_index(z, (Ellipsis, k, slice(None)))

    a11, a21 = ent(Va, 0), ent(Va, 1)
    b11, b21 = ent(Vb, 0), ent(Vb, 1)
    # even bins (z^n == 1): B12 = -kappa conj(B21), B22 = conj(B11)
    even11 = cdf_add(cdf_mul(b11, a11),
                     _kscale(cdf_mul(_cdf_conj(b21), a21), -kappa))
    even21 = cdf_add(cdf_mul(b21, a11), cdf_mul(_cdf_conj(b11), a21))
    # odd bins (z^n == -1): B12 = +kappa conj(B21), B22 = -conj(B11)
    tw = _cdf_reg(("df64_half_tw", n),
                  lambda: np.exp(-1j * np.pi * np.arange(n) / n))
    Bo = _value_odd_df64(Vb, tb, tw, n)
    Ao = _value_odd_df64(Va, ta, tw, n)
    a11o, a21o = ent(Ao, 0), ent(Ao, 1)
    b11o, b21o = ent(Bo, 0), ent(Bo, 1)
    odd11 = cdf_add(cdf_mul(b11o, a11o),
                    _kscale(cdf_mul(_cdf_conj(b21o), a21o), kappa))
    odd21 = cdf_sub(cdf_mul(b21o, a11o), cdf_mul(_cdf_conj(b11o), a21o))

    def ilv(ev, od):
        return jax.tree.map(
            lambda e, o: jnp.stack([e, o], axis=-1).reshape(
                e.shape[:-1] + (2 * n,)), ev, od)

    V_out = _cdf_stack([ilv(even11, odd11), ilv(even21, odd21)], axis=-2)

    def sc(z, k):
        return _cdf_index(z, (Ellipsis, k))

    # top(B12) = -kappa conj(c_B21); top(B22) = conj(c_B11);
    # zeroth(B12) = -kappa conj(t_B21); zeroth(B22) = conj(t_B11)
    t11 = cdf_add(cdf_mul(sc(tb, 0), sc(ta, 0)),
                  _kscale(cdf_mul(_cdf_conj(sc(cb, 1)), sc(ta, 1)), -kappa))
    t21 = cdf_add(cdf_mul(sc(tb, 1), sc(ta, 0)),
                  cdf_mul(_cdf_conj(sc(cb, 0)), sc(ta, 1)))
    c11 = cdf_add(cdf_mul(sc(cb, 0), sc(ca, 0)),
                  _kscale(cdf_mul(_cdf_conj(sc(tb, 1)), sc(ca, 1)), -kappa))
    c21 = cdf_add(cdf_mul(sc(cb, 1), sc(ca, 0)),
                  cdf_mul(_cdf_conj(sc(tb, 0)), sc(ca, 1)))
    t_out = _cdf_stack([t11, t21], axis=-1)
    c_out = _cdf_stack([c11, c21], axis=-1)
    return V_out, t_out, c_out


def _value_exit_sym_df64(Vc, tc, cc, kappa: int, n: int, want=None):
    """Column state on the n grid -> cdf coefficients [..., 2, 2, n+1]."""
    if want is None:
        want = ((0, 0), (0, 1), (1, 0), (1, 1))

    def col(z, k):
        return _cdf_index(z, (Ellipsis, k, slice(None)))

    def sc(z, k):
        return _cdf_index(z, (Ellipsis, k))

    entry = {
        (0, 0): (col(Vc, 0), sc(tc, 0)),
        (1, 0): (col(Vc, 1), sc(tc, 1)),
        (1, 1): (_cdf_conj(col(Vc, 0)), _cdf_conj(sc(cc, 0))),
        (0, 1): (_kscale(_cdf_conj(col(Vc, 1)), -kappa),
                 _kscale(_cdf_conj(sc(cc, 1)), -kappa)),
    }
    Vs = _cdf_stack([entry[ij][0] for ij in want], axis=-2)
    ts = _cdf_stack([entry[ij][1] for ij in want], axis=-1)
    qs = _fft_df64(Vs, n, inverse=True)
    q0 = cdf_sub(_cdf_index(qs, (Ellipsis, 0)), ts)
    qs = jax.tree.map(lambda qp, cp: qp.at[..., 0].set(cp), qs, q0)
    qs = jax.tree.map(lambda qp, tp: jnp.concatenate(
        [qp, tp[..., None]], axis=-1), qs, ts)
    lead = Vc[0][0].shape[:-2]
    out = _cdf_zeros_like(Vc, shape=lead + (2, 2, n + 1))
    for k, (i, j) in enumerate(want):
        sel = _cdf_index(qs, (Ellipsis, k, slice(None)))
        out = jax.tree.map(
            lambda op, sp, i=i, j=j: op.at[..., i, j, :].set(sp),
            out, sel)
    return out


def _matpoly_product_df64(b, a, length: int):
    """(b @ a)(z) on df64 coefficient arrays [..., 2, 2, c]."""
    fa = _fft_df64(_pad_last(a, length), length)
    fb = _fft_df64(_pad_last(b, length), length)
    # 2x2 polynomial matrix product in the FFT domain
    def entry(i, j):
        t0 = cdf_mul(_cdf_index(fb, (Ellipsis, i, 0, slice(None))),
                     _cdf_index(fa, (Ellipsis, 0, j, slice(None))))
        t1 = cdf_mul(_cdf_index(fb, (Ellipsis, i, 1, slice(None))),
                     _cdf_index(fa, (Ellipsis, 1, j, slice(None))))
        return cdf_add(t0, t1)

    rows = []
    for i in range(2):
        cols = [entry(i, j) for j in range(2)]
        rows.append(_cdf_stack(cols, axis=-2))
    fc = _cdf_stack(rows, axis=-3)
    return _fft_df64(fc, length, inverse=True)


def fmult2x2_tree_df64(p, *, want=None):
    """High-precision tree product of ``[n, 2, 2, c]`` complex128 inputs.

    Runs entirely in float32-pair arithmetic (complex-free) and returns
    (coefficients complex128, w int32) with the same 2^w normalization
    semantics as :func:`fnft_tpu.ops.poly.fmult2x2_tree` (including the
    value-space levels and ``want`` entry selection).
    """
    from fnft_tpu.ops.df64_pipeline import _tree_df64  # lazy: no cycle
    from fnft_tpu.utils.misc import next_power_of_2

    p = jnp.asarray(p)
    n = p.shape[0]
    deg_in = p.shape[-1] - 1
    n_pad = next_power_of_2(n)
    if n_pad != n:
        eye = np.zeros((n_pad - n, 2, 2, p.shape[-1]), dtype=np.complex128)
        eye[:, 0, 0, 0] = 1.0
        eye[:, 1, 1, 0] = 1.0
        p = jnp.concatenate([p, jnp.asarray(eye)], axis=0)

    out_cdf, w0 = _tree_df64(cdf_from_c128(p), n, deg_in, want=want)
    out = cdf_to_c128(out_cdf)
    return out[..., : n * deg_in + 1], w0


# ---------------------------------------------------------------------------
# df64 elementary functions (double-double libm subset for specfact)
# ---------------------------------------------------------------------------

def _df_const(val: float, like):
    v32 = np.float32(val)
    return (jnp.full_like(like, v32),
            jnp.full_like(like, np.float32(np.float64(val)
                                           - np.float64(v32))))


def _df_poly_eval(r, consts):
    """Horner sum of host-float64 constants over a df argument."""
    acc = _df_const(consts[-1], r[0])
    for c in reversed(consts[:-1]):
        acc = df_add(df_mul(acc, r), _df_const(c, r[0]))
    return acc


_EXP_TERMS = [1.0 / math.factorial(k) for k in range(14)]


def df_exp(x):
    """e^x for real df pairs (|result exponent| < 127)."""
    ln2 = float(np.log(np.float64(2.0)))
    n = jnp.round(x[0] / np.float32(ln2))
    r = df_sub(x, df_mul((n, jnp.zeros_like(n)), _df_const(ln2, n)))
    er = _df_poly_eval(r, _EXP_TERMS)
    s = jnp.ldexp(jnp.float32(1.0), n.astype(jnp.int32))  # exact 2^n
    return (er[0] * s, er[1] * s)


def df_log(x):
    """ln(x) for positive real df pairs: f32 seed + one exp-based Newton."""
    y0 = jnp.log(jnp.maximum(x[0], jnp.finfo(jnp.float32).tiny))
    e = df_exp((-y0, jnp.zeros_like(y0)))
    t = df_mul(x, e)                       # = x / e^{y0} ~ 1 + delta
    corr = df_add(t, _df_const(-1.0, y0))
    # ln(1+delta) ~ delta - delta^2/2 (delta ~ 1e-7: quadratic term 5e-15)
    half_d2 = df_mul(df_mul(corr, corr), _df_const(-0.5, y0))
    return df_add((y0, jnp.zeros_like(y0)), df_add(corr, half_d2))


def df_log1p(x):
    return df_log(df_add(_df_const(1.0, x[0]), x))


_SIN_TERMS = [(-1.0) ** k / math.factorial(2 * k + 1) for k in range(9)]
_COS_TERMS = [(-1.0) ** k / math.factorial(2 * k) for k in range(9)]


def df_sincos(x):
    """(sin x, cos x) for real df pairs via pi/2 quadrant reduction."""
    half_pi = float(np.pi / 2)
    n = jnp.round(x[0] / np.float32(half_pi))
    r = df_sub(x, df_mul((n, jnp.zeros_like(n)), _df_const(half_pi, n)))
    r2 = df_mul(r, r)
    s = df_mul(r, _df_poly_eval(r2, _SIN_TERMS))
    c = _df_poly_eval(r2, _COS_TERMS)
    quad = jnp.mod(n, 4.0)

    def pick(q0, q1, q2, q3):
        return (jnp.select([quad == 0, quad == 1, quad == 2], 
                           [q0[0], q1[0], q2[0]], q3[0]),
                jnp.select([quad == 0, quad == 1, quad == 2],
                           [q0[1], q1[1], q2[1]], q3[1]))

    neg = df_neg
    sin_out = pick(s, c, neg(s), neg(c))
    cos_out = pick(c, neg(s), neg(c), s)
    return sin_out, cos_out


def poly_specfact_df64(coeffs, *, oversampling_factor: int = 32,
                       kappa: int = 0):
    """Kolmogorov spectral factorization in df64 (cf. ops.specfact).

    complex128 in/out; log-magnitude -> Hilbert transform -> exp all run
    in float32-pair arithmetic (df_log/df_exp/df_sincos), FFTs via
    fft_df64 on a power-of-two oversampled grid. Matches the complex128
    implementation to ~1e-12.
    """
    from fnft_tpu.utils.misc import next_power_of_2

    c128 = np.asarray(coeffs, dtype=np.complex128)
    deg = c128.shape[-1] - 1
    m = next_power_of_2((deg + 1) * oversampling_factor)

    vals = fft_df64(cdf_from_c128(np.concatenate(
        [c128[::-1], np.zeros(m - deg - 1, np.complex128)])), m)
    re, im = vals
    abs2 = df_add(df_mul(re, re), df_mul(im, im))
    tol = math.sqrt(2.220446049250313e-16)  # sqrt(f64 eps), ref semantics
    half = (jnp.full_like(abs2[0], 0.5), jnp.zeros_like(abs2[0]))

    def clamp(v, lo):
        keep = v[0] > lo
        return (jnp.where(keep, v[0], np.float32(lo)),
                jnp.where(keep, v[1], np.float32(lo - np.float64(np.float32(lo)))))

    if kappa == 0:
        x = df_mul(half, df_log(clamp(abs2, (tol * tol) ** 2)))
    elif kappa == -1:
        x = df_mul(half, df_log1p(abs2))
    elif kappa == 1:
        one = (jnp.ones_like(abs2[0]), jnp.zeros_like(abs2[0]))
        x = df_mul(half, df_log(clamp(df_sub(one, abs2), tol * tol)))
    else:
        raise ValueError("kappa must be -1, 0 or +1")

    zero = jnp.zeros_like(x[0])
    xf = fft_df64((x, (zero, zero)), m)
    sgn = np.concatenate([[0.0], -np.ones(m // 2 - 1), [0.0],
                          np.ones(m - m // 2 - 1)]).astype(np.float32)
    sgn_j = jnp.asarray(sgn)
    # multiply by i*sgn: (re, im) -> (-sgn*im, sgn*re); sgn in {-1,0,1} exact
    rotated = ((-sgn_j * xf[1][0], -sgn_j * xf[1][1]),
               (sgn_j * xf[0][0], sgn_j * xf[0][1]))
    y = fft_df64(rotated, m, inverse=True)
    yr, yi = y

    # freq = exp(x - i y) = exp(x + yi) * (cos yr - i sin yr)
    mag = df_exp(df_add(x, yi))
    s_, c_ = df_sincos(yr)
    rc = df_mul(mag, c_)
    rs = df_mul(mag, s_)
    freq = (rc, (-rs[0], -rs[1]))
    factor = fft_df64(freq, m, inverse=True)
    out = cdf_to_c128(_cdf_index(factor, (slice(0, deg + 1),)))
    return np.conj(out)
