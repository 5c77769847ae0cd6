"""FFT as DFT matmuls, in real-pair arithmetic.

For a backend with no FFT HLO and no complex types (the complex-free tier,
:mod:`fnft_tpu.ops.rc`), a length-N DFT is computed as real matrix products
against host-precomputed DFT matrices:

* N <= _DIRECT_MAX: one complex matmul ``X = x @ W_N`` (4 real matmuls).
* larger N = N1*N2 (balanced powers of two): the classic four-step
  decomposition — reshape to (N1, N2), DFT over the N1 axis (matmul),
  twiddle by ``w_N^{n2 k1}``, DFT over the N2 axis (matmul, recursing if
  N2 is still large), transpose, flatten.

Arithmetic cost is O(N * (N1 + N2)) instead of O(N log N) — a deliberate
trade: the extra multiplies are large batched GEMMs (at
``Precision.HIGHEST``, so float32 never drops to TF32), which a matrix
unit runs far faster than a scalar FFT.  All tables (DFT matrices, twiddles) are
computed on the host in float64 with exact integer phase reduction, then
rounded once to f32 — each table entry is correct to f32 eps regardless
of N.

Replaces kiss_fft/FFTW of the C reference (fnft__fft_wrapper.h) on this
backend; the complex-typed XLA FFT path (ops/poly.py) remains the default
everywhere complex types exist.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from fnft_tpu.ops import rc, tables

_DIRECT_MAX = 2048  # largest single-matmul DFT (table = 2 * 16 MB f32)

_PREC = jax.lax.Precision.HIGHEST


@lru_cache(maxsize=None)
def _dft_table(n: int, sign: int) -> tuple[np.ndarray, np.ndarray]:
    """W[j, k] = exp(sign * 2i pi j k / n) as (re, im) f32 host arrays."""
    j = np.arange(n, dtype=np.int64)
    jk = np.mod(np.outer(j, j), n)  # exact integer phase reduction
    ang = (sign * 2.0 * np.pi / n) * jk.astype(np.float64)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@lru_cache(maxsize=None)
def _twiddle_table(n1: int, n2: int, sign: int) -> tuple[np.ndarray, np.ndarray]:
    """T[k1, n2] = exp(sign * 2i pi k1 n2 / (n1 n2)) as f32 host arrays."""
    n = n1 * n2
    k1 = np.arange(n1, dtype=np.int64)[:, None]
    m2 = np.arange(n2, dtype=np.int64)[None, :]
    ang = (sign * 2.0 * np.pi / n) * np.mod(k1 * m2, n).astype(np.float64)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _split(n: int) -> tuple[int, int]:
    """Balanced power-of-two factorization n = n1 * n2, n1 <= n2."""
    k = n.bit_length() - 1
    assert (1 << k) == n, f"mxu_fft requires power-of-two length, got {n}"
    return 1 << (k // 2), 1 << (k - k // 2)


def _matmul_dft(x: rc.Pair, n: int, sign: int) -> rc.Pair:
    """DFT over the last axis via one complex matmul (4 real einsums)."""
    wr, wi = tables.get(("dft", n, sign), lambda: _dft_table(n, sign))
    xr, xi = x
    rr = jnp.einsum("...j,jk->...k", xr, wr, precision=_PREC)
    ii = jnp.einsum("...j,jk->...k", xi, wi, precision=_PREC)
    ri = jnp.einsum("...j,jk->...k", xr, wi, precision=_PREC)
    ir = jnp.einsum("...j,jk->...k", xi, wr, precision=_PREC)
    return rr - ii, ri + ir


def _matmul_dft_axis2(x: rc.Pair, n1: int, sign: int) -> rc.Pair:
    """DFT over axis -2 (size n1) via one complex matmul."""
    wr, wi = tables.get(("dft", n1, sign), lambda: _dft_table(n1, sign))
    xr, xi = x
    rr = jnp.einsum("jk,...jn->...kn", wr, xr, precision=_PREC)
    ii = jnp.einsum("jk,...jn->...kn", wi, xi, precision=_PREC)
    ri = jnp.einsum("jk,...jn->...kn", wi, xr, precision=_PREC)
    ir = jnp.einsum("jk,...jn->...kn", wr, xi, precision=_PREC)
    return rr - ii, ri + ir


def _fft_pair_raw(x: rc.Pair, sign: int) -> rc.Pair:
    n = x[0].shape[-1]
    if n <= _DIRECT_MAX:
        return _matmul_dft(x, n, sign)
    n1, n2 = _split(n)
    lead = x[0].shape[:-1]
    a = rc.reshape(x, lead + (n1, n2))
    b = _matmul_dft_axis2(a, n1, sign)           # DFT over n1 -> index k1
    tw = tables.get(("twiddle", n1, n2, sign),
                    lambda: _twiddle_table(n1, n2, sign))
    c = rc.mul(b, tw)                            # twiddle w^{k1 n2}
    d = _fft_pair_raw(c, sign)                   # DFT over n2 -> index k2
    # X[k2 * n1 + k1] = D[k1, k2]
    d = rc.apply(jnp.swapaxes, d, -1, -2)
    return rc.reshape(d, lead + (n,))


def fft_pair(x: rc.Pair) -> rc.Pair:
    """Forward DFT over the last axis (np.fft.fft convention, sign -1)."""
    return _fft_pair_raw(x, -1)


def ifft_pair(x: rc.Pair) -> rc.Pair:
    """Inverse DFT over the last axis (normalized by 1/N)."""
    n = x[0].shape[-1]
    y = _fft_pair_raw(x, +1)
    s = np.float32(1.0 / n)
    return y[0] * s, y[1] * s


def set_direct_max(n: int) -> None:
    """Tune the single-matmul cutoff (tables are cached per size)."""
    global _DIRECT_MAX
    _DIRECT_MAX = int(n)
