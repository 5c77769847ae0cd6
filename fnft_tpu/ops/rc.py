"""Real-pair complex arithmetic for backends without complex types.

A complex array is carried as a ``(re, im)`` pair of real arrays, and every
complex primitive the NFT pipelines need is written out in real arithmetic.
Combined with :mod:`fnft_tpu.ops.mxu_fft` (FFT as DFT matmuls) this runs
the full contspec pipeline on a device that lowers no complex-typed HLO and
no FFT at all: every hot op is a real matmul or an elementwise op.

No counterpart exists in the C reference (complex doubles are native
there). The layer was written for an accelerator without complex types or
float64; on a device with native complex128 the ``models/`` drivers are the
main path, and this tier is kept until the c128 path is shown to meet the
same bounds at least as fast (ROADMAP D2).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

Pair = tuple  # (re, im) of equal-shape real arrays


def from_complex(x) -> Pair:
    """Split a complex array into an (re, im) pair.

    Host (numpy) inputs are split on the host so no complex-typed array is
    ever created on a device — required on backends with no complex
    support at all."""
    if isinstance(x, np.ndarray) or np.isscalar(x):
        x = np.asarray(x)
        if np.iscomplexobj(x):
            return (jnp.asarray(np.ascontiguousarray(x.real)),
                    jnp.asarray(np.ascontiguousarray(x.imag)))
        x = jnp.asarray(x)
        return x, jnp.zeros_like(x)
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        return jnp.real(x), jnp.imag(x)
    return x, jnp.zeros_like(x)


def to_complex(p: Pair):
    re, im = p
    return jnp.asarray(re) + 1j * jnp.asarray(im)


def const(x, dtype=np.float32) -> Pair:
    """Host complex constant -> f32 pair (phase computed at full precision)."""
    x = np.asarray(x)
    return (jnp.asarray(np.real(x).astype(dtype)),
            jnp.asarray(np.imag(x).astype(dtype)))


def add(a: Pair, b: Pair) -> Pair:
    return a[0] + b[0], a[1] + b[1]


def sub(a: Pair, b: Pair) -> Pair:
    return a[0] - b[0], a[1] - b[1]


def neg(a: Pair) -> Pair:
    return -a[0], -a[1]


def mul(a: Pair, b: Pair) -> Pair:
    """(a.re + i a.im)(b.re + i b.im): 4 real multiplies, fused by XLA."""
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def rmul(a: Pair, s) -> Pair:
    """Multiply by a real scalar/array."""
    return a[0] * s, a[1] * s


def conj(a: Pair) -> Pair:
    return a[0], -a[1]


def abs2(a: Pair):
    return a[0] * a[0] + a[1] * a[1]


def cabs(a: Pair):
    return jnp.sqrt(abs2(a))


def div(a: Pair, b: Pair) -> Pair:
    """a / b via the conjugate trick (one real reciprocal)."""
    d = abs2(b)
    inv = 1.0 / d
    nr, ni = mul(a, conj(b))
    return nr * inv, ni * inv


def cis(theta) -> Pair:
    """exp(i theta) for a real angle array."""
    return jnp.cos(theta), jnp.sin(theta)


def stack(pairs, axis=0) -> Pair:
    return (jnp.stack([p[0] for p in pairs], axis=axis),
            jnp.stack([p[1] for p in pairs], axis=axis))


def concatenate(pairs, axis=0) -> Pair:
    return (jnp.concatenate([p[0] for p in pairs], axis=axis),
            jnp.concatenate([p[1] for p in pairs], axis=axis))


def zeros(shape, dtype=jnp.float32) -> Pair:
    z = jnp.zeros(shape, dtype)
    return z, jnp.zeros_like(z)


def reshape(a: Pair, shape) -> Pair:
    return a[0].reshape(shape), a[1].reshape(shape)


def apply(f, a: Pair, *args, **kw) -> Pair:
    """Apply the same real->real shape/layout op to both components."""
    return f(a[0], *args, **kw), f(a[1], *args, **kw)
