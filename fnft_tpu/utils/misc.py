"""Numeric helpers (Rebuild of the reference's fnft__misc.c).

Key departure from the C original: filtering/merging cannot compact arrays
under jit (static shapes), so the masked variants here return ``(values,
mask)`` pairs. Drivers compact at the API boundary on the host.

Reference parity map (file:line into /root/reference):
  rel_err           -> src/private/fnft__misc.c:41-51
  hausdorff_dist    -> src/private/fnft__misc.c:53-83
  sech              -> src/private/fnft__misc.c:85-88
  l2norm2           -> src/private/fnft__misc.c:90-112 (trapezoid)
  filter_mask       -> src/private/fnft__misc.c:114-157 (bounding box)
  merge_mask        -> src/private/fnft__misc.c:228-259 (dedupe within tol)
  resample          -> src/private/fnft__misc.c:326-407 (FFT fractional delay)
  csinc             -> src/private/fnft__misc.c:306-314
  next_power_of_2   -> src/private/fnft__misc.c:316-324
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from fnft_tpu.config import complex_dtype_of, eps_of


def rel_err(numer, exact) -> jnp.ndarray:
    """Sum-of-abs relative error between two complex vectors."""
    numer = jnp.asarray(numer).ravel()
    exact = jnp.asarray(exact).ravel()
    return jnp.sum(jnp.abs(numer - exact)) / jnp.sum(jnp.abs(exact))


def hausdorff_dist(a, b) -> jnp.ndarray:
    """Symmetric Hausdorff distance between two point sets in C."""
    a = jnp.asarray(a).ravel()[:, None]
    b = jnp.asarray(b).ravel()[None, :]
    d = jnp.abs(a - b)
    return jnp.maximum(jnp.max(jnp.min(d, axis=1)), jnp.max(jnp.min(d, axis=0)))


def sech(z):
    z = jnp.asarray(z)
    return 2.0 / (jnp.exp(z) + jnp.exp(-z))


def l2norm2(vals, t0: float, t1: float) -> jnp.ndarray:
    """Trapezoid-weighted squared L2 norm of a sampled signal."""
    vals = jnp.asarray(vals)
    n = vals.shape[-1]
    h = (t1 - t0) / n
    w = jnp.ones((n,), dtype=jnp.abs(vals).dtype).at[0].set(0.5).at[-1].set(0.5)
    return h * jnp.sum(w * jnp.abs(vals) ** 2, axis=-1)


def csinc(x):
    """sinc(x) = sin(x)/x with a series-stable branch near 0 (complex-safe)."""
    x = jnp.asarray(x)
    small = jnp.abs(x) < 1e-8
    safe = jnp.where(small, jnp.ones_like(x), x)
    return jnp.where(small, jnp.cos(x / jnp.sqrt(jnp.asarray(3.0, x.dtype))),
                     jnp.sin(safe) / safe)


def next_power_of_2(n: int) -> int:
    if n <= 0:
        return 0
    return 1 << (int(n) - 1).bit_length()


def _next_fast_size(n: int) -> int:
    """Smallest 2^a 3^b 5^c >= n (kiss_fft_next_fast_size semantics)."""
    if n <= 1:
        return 1
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def next_fft_length(n: int) -> int:
    """Next efficient FFT length for the active backend.

    Accelerator backends pad to powers of two; the CPU backend (pocketfft) handles
    mixed-radix 2^a 3^b 5^c sizes efficiently — matching the reference's
    kiss_fft_next_fast_size and cutting the fmult tree's FFT work by up
    to ~2x versus always rounding to a power of two.
    """
    import jax

    if jax.default_backend() == "cpu":
        return _next_fast_size(int(n))
    return next_power_of_2(n)


def filter_mask(vals, bounding_box) -> jnp.ndarray:
    """Mask of values inside [re0, re1] x [im0, im1]; NaNs excluded."""
    vals = jnp.asarray(vals)
    re, im = jnp.real(vals), jnp.imag(vals)
    re0, re1, im0, im1 = bounding_box
    return (re >= re0) & (re <= re1) & (im >= im0) & (im <= im1)


def filter_inv_mask(vals, bounding_box) -> jnp.ndarray:
    """Mask of values OUTSIDE the open box (reference misc_filter_inv,
    misc.c:159-203); NaNs are kept."""
    vals = jnp.asarray(vals)
    re, im = jnp.real(vals), jnp.imag(vals)
    re0, re1, im0, im1 = bounding_box
    inside = (re > re0) & (re < re1) & (im > im0) & (im < im1)
    return ~inside


def filter_nonreal_mask(vals, tol_im: float) -> jnp.ndarray:
    """Mask of values with |Im| > tol (reference misc_filter_nonreal)."""
    return jnp.abs(jnp.imag(jnp.asarray(vals))) > tol_im


def downsample(q, dsub_desired: int):
    """Decimate to ~dsub samples; returns (qsub, (first, last) indices)
    (reference misc_downsample, misc.c:261-302)."""
    import numpy as np

    q = jnp.asarray(q)
    d = q.shape[-1]
    dsub, nskip = downsample_indices(d, dsub_desired)
    idx = np.arange(dsub) * nskip
    return q[..., idx], (0, int(idx[-1]))


def merge_mask(vals, tol: float, mask=None) -> jnp.ndarray:
    """Keep the first of every cluster of points closer than ``tol``.

    Parallel O(K^2) formulation: point i survives if no valid earlier point j
    lies within tol. ``mask`` marks which entries are valid to begin with.
    Above 2048 points the distance matrix is built in column chunks (a
    fori_loop) so the transient buffer stays bounded — the D=2^20
    subsample-and-refine path feeds ~4e4 candidate roots through here.
    """
    import jax

    vals = jnp.asarray(vals)
    k = vals.shape[-1]
    if mask is None:
        mask = jnp.ones((k,), dtype=bool)
    if k <= 2048:
        d = jnp.abs(vals[:, None] - vals[None, :])
        earlier = jnp.tril(jnp.ones((k, k), dtype=bool), k=-1)
        close_to_earlier = jnp.any(earlier & (d < tol) & mask[None, :], axis=1)
        return mask & ~close_to_earlier

    chunk = 1024
    nch = -(-k // chunk)
    vp = jnp.pad(vals, (0, nch * chunk - k))
    mp = jnp.pad(mask, (0, nch * chunk - k))
    idx = jnp.arange(k)

    def body(c, acc):
        vc = jax.lax.dynamic_slice_in_dim(vp, c * chunk, chunk)
        mc = jax.lax.dynamic_slice_in_dim(mp, c * chunk, chunk)
        jc = c * chunk + jnp.arange(chunk)
        close = ((jnp.abs(vals[:, None] - vc[None, :]) < tol)
                 & mc[None, :] & (jc[None, :] < idx[:, None]))
        return acc | jnp.any(close, axis=1)

    close_to_earlier = jax.lax.fori_loop(0, nch, body,
                                         jnp.zeros((k,), dtype=bool))
    return mask & ~close_to_earlier


def merge_points_host(vals, tol: float):
    """Host-side dedupe of complex points within ``tol`` (keep-first).

    Sorted sliding window in the real part makes this O(k log k + k w)
    instead of a k x k distance matrix — the root arrays can reach ~4e4
    entries for D=2^20 subsampled monodromy polynomials.
    """
    import numpy as np

    vals = np.asarray(vals)
    k = vals.shape[0]
    if k <= 1:
        return vals
    order = np.argsort(vals.real, kind="stable")
    svals = vals[order]
    keep_sorted = np.ones(k, dtype=bool)
    start = 0
    for i in range(1, k):
        while svals[i].real - svals[start].real > tol:
            start += 1
        window = svals[start:i][keep_sorted[start:i]]
        if window.size and np.min(np.abs(window - svals[i])) < tol:
            keep_sorted[i] = False
    keep = np.zeros(k, dtype=bool)
    keep[order] = keep_sorted
    # preserve original (keep-first) ordering semantics
    return vals[keep]


def compact_masked(vals, mask):
    """Host-side compaction of (values, mask) into a short array."""
    import numpy as np

    vals = np.asarray(vals)
    mask = np.asarray(mask)
    return vals[mask]


def resample(q, eps_t: float, delta: float, *, check_bandlimit: bool = False):
    """Band-limited fractional-delay resampling: q(t) -> q(t + delta).

    FFT phase-shift on the periodic continuation of the signal. ``delta``
    may be a scalar or a vector (a stack of shifted copies is returned).
    """
    q = jnp.asarray(q)
    cdt = complex_dtype_of(q)
    q = q.astype(cdt)
    d = q.shape[-1]
    spec = jnp.fft.fft(q, axis=-1)
    freq = jnp.fft.fftfreq(d, d=eps_t).astype(jnp.real(q).dtype)
    delta_arr = jnp.atleast_1d(jnp.asarray(delta, dtype=jnp.real(q).dtype))
    phase = jnp.exp(2j * math.pi * delta_arr[:, None] * freq[None, :]).astype(cdt)
    out = jnp.fft.ifft(spec[..., None, :] * phase, axis=-1)
    if jnp.ndim(delta) == 0:
        out = out[..., 0, :]
    return out.astype(cdt)


def bandlimit_violation(q, eps_t: float) -> jnp.ndarray:
    """Fraction of spectral energy in the top 10% band (reference warns if
    this exceeds sqrt(machine eps); misc.c:370-380)."""
    q = jnp.asarray(q)
    d = q.shape[-1]
    spec = jnp.fft.fft(q)
    dlp = d // 20
    hi = jnp.concatenate([spec[d // 2 - 1 - dlp: d // 2 - 1],
                          spec[d // 2 + 1: d // 2 + 1 + dlp]])
    # same trapezoid step h = eps_t for both norms (reference uses
    # misc_l2norm2(Dlp, ..., 0, Dlp*eps_t) / misc_l2norm2(D, ..., 0, D*eps_t))
    num = l2norm2(hi, 0.0, hi.shape[-1] * eps_t)
    den = l2norm2(spec, 0.0, d * eps_t)
    return jnp.sqrt(num / den)


def downsample_indices(d: int, dsub_desired: int) -> tuple[int, int]:
    """(actual Dsub, skip) for decimation, reference misc.c:275-282."""
    dsub = min(max(int(dsub_desired), 2), d)
    nskip = int(round(d / dsub))
    dsub = int(round(d / nskip))
    return dsub, nskip


def merge_tol_default(dtype) -> float:
    """sqrt(machine eps), the reference's bound-state merge tolerance."""
    return math.sqrt(eps_of(dtype))
