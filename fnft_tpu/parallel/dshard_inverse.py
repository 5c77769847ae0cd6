"""D-sharded inverse scattering: distributed FFTs over the seq mesh axis.

The inverse NFT's divide-and-conquer layer peel
(ops/finvscatter.py, reference fnft__nse_finvscatter.c:243-366) is
sequential across its two half-blocks (T1 needs T2's inverse), so the
parallel resource is *within* a level: the T1-window and merge products
are FFT convolutions of length ~2.deg — at the top levels these are
size-2D transforms, exactly where splitting work across chips pays.

This module supplies:

* a **distributed four-step FFT** pair over a mesh axis, the standard
  transpose algorithm (Bailey): view x[n], n = r + R.c as A[r, c] with
  L = R.C; then X[k2 + C.k1] = FFT_r( w_L^{r.k2} . FFT_c(A) ), so the
  schedule is local FFT over c -> twiddle -> all_to_all transpose
  -> local FFT over r.  Outputs stay in the permuted (k2, k1) layout,
  which pointwise products and the inverse transform both preserve —
  the layout permutation cancels inside a convolution;
* a **sharded 2x2 polynomial matrix product** built on that pair (each
  device transforms C/P of the spectral columns);
* ``dshard_finvscatter``: the host-staged peel of ops/finvscatter.py
  with every product at deg >= ``min_sharded_deg`` dispatched through
  the sharded convolution, and the sub-threshold blocks running the
  existing local shape-cached kernels.

Coefficient arrays stay replicated between stages ([2, 2, deg+1] is
small even at D = 2^20); only the O(L log L) transform work inside a
product is partitioned. Communication per product: two all_to_all
transposes + one all_gather, all device to device.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from fnft_tpu.models.discretization import Discretization, degree
from fnft_tpu.ops import finvscatter as _fi
from fnft_tpu.utils.misc import next_power_of_2


def _factor(length: int, p: int) -> tuple[int, int]:
    """length = R*C with R, C divisible by the mesh size p (powers of two)."""
    assert length & (length - 1) == 0, "sharded FFT needs a power-of-two length"
    logl = int(math.log2(length))
    logp = int(math.log2(p))
    assert p & (p - 1) == 0 and logl >= 2 * logp, \
        f"length {length} too small for {p}-way sharded FFT"
    logr = max(logp, (logl + 1) // 2)
    return 1 << logr, 1 << (logl - logr)


def _fft_last(x, inverse: bool = False):
    """FFT over the last axis with the input forced into default layout.

    XLA:CPU's fft thunk RET_CHECKs IsMonotonicWithDim0Major on its input;
    a transpose fused into the FFT operand violates it. Collapsing the
    leading axes to 2-D forces a materialized standard-layout copy."""
    shape = x.shape
    x2 = x.reshape((-1, shape[-1]))
    y = jnp.fft.ifft(x2, axis=-1) if inverse else jnp.fft.fft(x2, axis=-1)
    return y.reshape(shape)


def _fft_axis2(x, inverse: bool = False):
    """(I)FFT over axis=-2 via swap + standard-layout last-axis FFT."""
    return jnp.swapaxes(_fft_last(jnp.swapaxes(x, -1, -2), inverse), -1, -2)


def _fwd_local(x, *, r: int, c: int, p: int, axis: str):
    """Replicated [..., L] -> this device's [..., C/P, R] block of the
    permuted spectrum X[k2 + C k1] (k2 sharded)."""
    idx = jax.lax.axis_index(axis)
    length = r * c
    a = x.reshape(x.shape[:-1] + (c, r))  # A[c_slow, r_fast]: n = r + R*c
    a_loc = jax.lax.dynamic_slice_in_dim(a, idx * (c // p), c // p, axis=-2)
    # -> [..., C, R/P]: full c locally, r sharded (chunk idx of R)
    b = jax.lax.all_to_all(a_loc, axis, split_axis=a_loc.ndim - 1,
                           concat_axis=a_loc.ndim - 2, tiled=True)
    f1 = _fft_axis2(b)  # over c -> [..., k2=C, R/P]
    r_glob = idx * (r // p) + jnp.arange(r // p)
    k2 = jnp.arange(c)
    tw = jnp.exp((-2j * math.pi / length)
                 * k2[:, None].astype(jnp.float64)
                 * r_glob[None, :].astype(jnp.float64)).astype(f1.dtype)
    f1 = f1 * tw
    # -> [..., C/P, R]: k2 sharded, full r locally
    g = jax.lax.all_to_all(f1, axis, split_axis=f1.ndim - 2,
                           concat_axis=f1.ndim - 1, tiled=True)
    return _fft_last(g)  # over r -> X[k2_loc, k1]


def _inv_local(x_loc, *, r: int, c: int, p: int, axis: str):
    """Inverse of :func:`_fwd_local`; returns the replicated [..., L]."""
    idx = jax.lax.axis_index(axis)
    length = r * c
    y = _fft_last(x_loc, inverse=True)  # undo FFT over r
    h = jax.lax.all_to_all(y, axis, split_axis=y.ndim - 1,
                           concat_axis=y.ndim - 2, tiled=True)  # [..., C, R/P]
    r_glob = idx * (r // p) + jnp.arange(r // p)
    k2 = jnp.arange(c)
    tw = jnp.exp((2j * math.pi / length)
                 * k2[:, None].astype(jnp.float64)
                 * r_glob[None, :].astype(jnp.float64)).astype(h.dtype)
    h = _fft_axis2(h * tw, inverse=True)  # undo FFT over c
    a_loc = jax.lax.all_to_all(h, axis, split_axis=h.ndim - 2,
                               concat_axis=h.ndim - 1, tiled=True)  # [C/P, R]
    a = jax.lax.all_gather(a_loc, axis, axis=a_loc.ndim - 2, tiled=True)
    return a.reshape(a.shape[:-2] + (length,))


def make_sharded_polymatmul(ca: int, cb: int, mesh: Mesh, *,
                            seq_axis: str = "seq",
                            dtype=jnp.complex128):
    """Jitted (a [..., 2, 2, ca], b [..., 2, 2, cb]) -> a@b [..., 2, 2, ca+cb-1]
    with the convolution FFTs partitioned over ``mesh[seq_axis]``."""
    p = mesh.shape[seq_axis]
    n_out = ca + cb - 1
    length = next_power_of_2(n_out)
    r, c = _factor(length, p)

    def body(a, b):
        ap = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, length - ca)])
        bp = jnp.pad(b, [(0, 0)] * (b.ndim - 1) + [(0, length - cb)])
        fa = _fwd_local(ap, r=r, c=c, p=p, axis=seq_axis)  # [..., 2, 2, C/P, R]
        fb = _fwd_local(bp, r=r, c=c, p=p, axis=seq_axis)
        o = jnp.stack([
            jnp.stack([fa[..., 0, 0, :, :] * fb[..., 0, 0, :, :]
                       + fa[..., 0, 1, :, :] * fb[..., 1, 0, :, :],
                       fa[..., 0, 0, :, :] * fb[..., 0, 1, :, :]
                       + fa[..., 0, 1, :, :] * fb[..., 1, 1, :, :]], axis=-3),
            jnp.stack([fa[..., 1, 0, :, :] * fb[..., 0, 0, :, :]
                       + fa[..., 1, 1, :, :] * fb[..., 1, 0, :, :],
                       fa[..., 1, 0, :, :] * fb[..., 0, 1, :, :]
                       + fa[..., 1, 1, :, :] * fb[..., 1, 1, :, :]], axis=-3),
        ], axis=-4)
        out = _inv_local(o, r=r, c=c, p=p, axis=seq_axis)
        return out[..., :n_out].astype(dtype)

    sharded = shard_map(body, mesh=mesh, in_specs=(P(), P()),
                        out_specs=P(), check_vma=False)
    return jax.jit(sharded)


def sharded_fft_reference(x, mesh: Mesh, *, seq_axis: str = "seq"):
    """Distributed FFT of a replicated [..., L] (permuted layout undone):
    test/debug surface for the four-step kernel."""
    p = mesh.shape[seq_axis]
    length = x.shape[-1]
    r, c = _factor(length, p)

    def body(xx):
        f = _fwd_local(xx, r=r, c=c, p=p, axis=seq_axis)  # [..., C/P, R]
        f = jax.lax.all_gather(f, seq_axis, axis=f.ndim - 2, tiled=True)
        return f  # [..., C, R]: X[k2 + C*k1] at [k2, k1]

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(),), out_specs=P(),
                          check_vma=False))(x)
    # un-permute: X[k2 + C*k1] = f[k2, k1] -> transpose to [k1, k2] row-major
    # flat index k1*C + k2?  No: k = k2 + C*k1 means k1 is the SLOW digit.
    xk = jnp.swapaxes(f, -1, -2)  # [..., R(k1), C(k2)] -> flat k = k1*C + k2
    return xk.reshape(x.shape[:-1] + (length,))


def dshard_finvscatter(transfer_matrix, eps_t: float, kappa: int,
                       mesh: Mesh, *,
                       disc: Discretization = Discretization.SPLIT2A,
                       seq_axis: str = "seq",
                       min_sharded_deg: int = 2048):
    """ops/finvscatter.finvscatter with top-level products sharded.

    Every T1-window / merge product whose larger factor has
    deg >= min_sharded_deg runs its convolution FFTs partitioned over the
    mesh; smaller blocks fall through to the local shape-cached staged
    kernels (bit-comparable results either way up to f.p. reassociation).
    """
    t = jnp.asarray(transfer_matrix)
    cdt = t.dtype if jnp.issubdtype(t.dtype, jnp.complexfloating) \
        else jnp.complex128
    t = t.astype(cdt)
    deg = t.shape[-1] - 1
    d = deg // max(degree(disc), 1)
    if d < 2 or d & (d - 1):
        raise ValueError("D must be a positive power of two")

    mm_cache: dict[tuple[int, int], object] = {}

    def _mm(a, b, out_len=None):
        key = (a.shape[-1], b.shape[-1])
        if key not in mm_cache:
            mm_cache[key] = make_sharded_polymatmul(
                key[0], key[1], mesh, seq_axis=seq_axis, dtype=cdt)
        out = mm_cache[key](a, b)
        return out if out_len is None else out[..., :out_len]

    out: list = []

    def _recurse(tt, dg, need_inverse, offset):
        if dg < min_sharded_deg:
            return _fi._recurse_staged(tt, dg, eps_t, kappa, disc,
                                       need_inverse, out, offset)
        d2 = dg // 2
        t2i = _recurse(tt[..., :d2 + 1], d2, True, offset + d2)
        t1 = _mm(t2i, tt, out_len=dg + 1)[..., d2: dg + 1]
        t1i = _recurse(t1, d2, need_inverse, offset)
        return _mm(t1i, t2i) if need_inverse else None

    _recurse(t, deg, False, 0)
    out.sort(key=lambda kv: kv[0])
    return jnp.concatenate([blk for _, blk in out], axis=-1)
