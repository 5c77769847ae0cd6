"""Time-axis (D) sharding of the fast NFT over a device mesh.

This is the analogue of sequence parallelism for the reference's
O(D log^2 D) pipeline (SURVEY.md section 2.8/5.7; the sequential tree it
distributes is fnft__poly_fmult.c:381-546):

* the D samples are split into S contiguous time chunks, one per device on
  the ``seq`` mesh axis;
* each device builds its per-sample transfer matrices and runs the FFT
  tree **only on its chunk** — the first log2(D/S) tree levels, which carry
  ~80% of the FLOPs, are perfectly work-partitioned;
* instead of merging the S chunk polynomials in coefficient space (the
  last log2(S) tree levels, whose long-polynomial products are the most
  expensive per level), each device chirp-Z-evaluates its own chunk
  polynomial at the M spectral points and the ordered matrix product
  ``H(xi) = P_{S-1}(xi) @ ... @ P_0(xi)`` is composed **in value space**
  by a log2(S)-step butterfly of ``ppermute`` exchanges between devices, with a
  power-of-two rescale per step (the reference's 2^W normalization,
  fnft__poly_fmult.c:123-150, carried as an integer exponent);
* the final reflection coefficient / a / b arrays come out sharded over
  the same mesh axis (each device keeps its M/S block).

Per-device FLOPs therefore scale ~1/S for the tree and stay O((D/S + M)
log) for the evaluation; communication is log2(S) exchanges of [M, 2, 2]
values — device to device, no host round-trips.

Restrictions: fast (polynomial) schemes, D and M divisible by S. The
upsampled 4SPLIT4A/B schemes are supported via one all_gather of q before
the (replicated) CF-stage resample; everything downstream stays sharded.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from fnft_tpu.models.discretization import (
    Discretization,
    degree,
    is_fast,
    upsampling_factor,
)
from fnft_tpu.models import nse
from fnft_tpu.models.nsev import ContspecType, _apply_phase_factors
from fnft_tpu.ops.fscatter import transfer_matrix_coeffs
from fnft_tpu.ops.poly import chirpz, fmult2x2_tree


def _value_renorm(v, w):
    """Rescale a [..., M, 2, 2] value stack by a power of two; fold into w."""
    rdt = jnp.real(v).dtype
    max_abs = jnp.max(jnp.abs(v), axis=(-3, -2, -1))
    safe = jnp.where(max_abs > 0, max_abs, 1.0)
    a_exp = jnp.where(max_abs > 0, jnp.floor(jnp.log2(safe)), 0.0).astype(jnp.int32)
    # ldexp, not exp2: XLA:CPU's exp2 is inexact (~1e-6 rel in f32)
    v = v * jnp.ldexp(jnp.asarray(1.0, rdt), -a_exp)[..., None, None, None]
    return v, w + a_exp


def _butterfly_fold(v, w, seq_axis: str, s: int):
    """Ordered product over the seq axis of per-shard [..., M, 2, 2] values.

    After log2(S) exchange steps every device holds
    ``V_{S-1} @ ... @ V_0`` (later time chunks multiply from the left,
    matching fmult2x2_tree's composition order) and the summed exponent w.
    """
    idx = jax.lax.axis_index(seq_axis)
    steps = int(math.log2(s))
    for k in range(steps):
        bit = 1 << k
        perm = [(i, i ^ bit) for i in range(s)]
        v_in = jax.lax.ppermute(v, seq_axis, perm)
        w_in = jax.lax.ppermute(w, seq_axis, perm)
        upper = (idx & bit) != 0
        # my chunk covers later times than the partner's iff my bit is set
        left = jnp.where(upper, 1, 0)
        mine_left = jnp.einsum("...ik,...kj->...ij", v, v_in)
        mine_right = jnp.einsum("...ik,...kj->...ij", v_in, v)
        v = jnp.where(left[..., None, None, None].astype(bool),
                      mine_left, mine_right)
        w = w + w_in
        v, w = _value_renorm(v, w)
    return v, w


def make_dshard_contspec(d: int, t_span, m: int, xi_span, mesh: Mesh, *,
                         kappa: int = +1,
                         disc: Discretization = Discretization.SPLIT4B,
                         seq_axis: str = "seq", batch_axis: str | None = None,
                         contspec_type=ContspecType.REFLECTION_COEFFICIENT):
    """Compile a D-sharded contspec function ``q[..., D] -> dict of [..., M]``.

    The returned callable is jitted; its input is sharded over
    ``(batch_axis?, seq_axis)`` and its outputs over the same axes (each
    device holds an M/S block of the spectrum).
    """
    if not is_fast(disc):
        raise ValueError(f"dshard supports fast (polynomial) schemes; got {disc}")
    ups = upsampling_factor(disc)
    from fnft_tpu.parallel.sharding import as_auto_mesh
    mesh = as_auto_mesh(mesh)
    s = mesh.shape[seq_axis]
    if d % s or m % s:
        raise ValueError(f"D={d} and M={m} must be divisible by the "
                         f"'{seq_axis}' mesh size {s}")

    t0, t1 = float(t_span[0]), float(t_span[1])
    xi0, xi1 = float(xi_span[0]), float(xi_span[1])
    eps_t = (t1 - t0) / (d - 1)
    deg1 = 2.0 / nse.xi_map_coeff(disc)  # = degree * upsampling
    eps_xi = (xi1 - xi0) / (m - 1) if m > 1 else 0.0
    a_pt = complex(np.exp(2j * xi0 * eps_t / deg1))
    w_pt = complex(np.exp(2j * eps_xi * eps_t / deg1))
    m_loc = m // s

    def body(q_loc):
        if ups == 1:
            q_eff = q_loc
            r_eff = -kappa * jnp.conj(q_loc)
        else:
            # 4SPLIT4A/B (CF4_2 stages): the stage construction needs a
            # full-length FFT resample (nse.preprocess_signal), a global op.
            # Gather q once (D values between devices — tiny next to the local
            # O((D/S) log^2) tree), build the stages replicated, and keep
            # this device's contiguous ups*(D/S) stage samples (stages are
            # interleaved per original sample, so chunk boundaries align).
            q_full = jax.lax.all_gather(q_loc, seq_axis, axis=-1, tiled=True)
            qe, re, _, _ = nse.preprocess_signal(q_full, eps_t, kappa, disc)
            loc = ups * (d // s)
            start = jax.lax.axis_index(seq_axis) * loc
            q_eff = jax.lax.dynamic_slice_in_dim(qe, start, loc, -1)
            r_eff = jax.lax.dynamic_slice_in_dim(re, start, loc, -1)
        p = transfer_matrix_coeffs(q_eff, r_eff, eps_t, disc)
        tm, w = fmult2x2_tree(p, normalize=True,
                              jsym=kappa)                 # [..., 2, 2, c]
        c = tm.shape[-1]
        flat = tm.reshape(tm.shape[:-3] + (4, c))
        vals = chirpz(flat, a_pt, w_pt, m)                # [..., 4, M]
        v = jnp.moveaxis(vals, -2, -1).reshape(tm.shape[:-3] + (m, 2, 2))
        v, w = _value_renorm(v, w)
        v, w = _butterfly_fold(v, w, seq_axis, s)
        h11, h21 = v[..., 0, 0], v[..., 1, 0]
        cs = _apply_phase_factors(h11, h21, w, eps_t, t0, t1, d, xi0, xi1,
                                  m, kappa, disc, contspec_type)
        # keep only this device's spectral block: output sharded over seq
        idx = jax.lax.axis_index(seq_axis)
        return {k: jax.lax.dynamic_slice_in_dim(val, idx * m_loc, m_loc, -1)
                for k, val in cs.items()}

    lead = (batch_axis,) if batch_axis is not None else ()
    in_spec = P(*lead, seq_axis)
    out_spec = P(*lead, seq_axis)
    sharded = shard_map(body, mesh=mesh, in_specs=(in_spec,),
                        out_specs=out_spec, check_vma=False)
    fn = jax.jit(sharded)

    def run(q):
        q = jax.device_put(jnp.asarray(q), NamedSharding(mesh, in_spec))
        return fn(q)

    run.sharded_fn = fn
    run.in_sharding = NamedSharding(mesh, in_spec)
    return run


def dshard_contspec_reference(q, d: int, t_span, m: int, xi_span, *,
                              kappa: int = +1,
                              disc: Discretization = Discretization.SPLIT4B,
                              s: int = 8,
                              contspec_type=ContspecType.REFLECTION_COEFFICIENT):
    """Single-device replica of the sharded math (for equivalence tests).

    Performs the identical chunk-tree + value-space butterfly with
    reshape/indexing instead of collectives, so an S-device run of
    :func:`make_dshard_contspec` can be compared against it directly.
    """
    t0, t1 = float(t_span[0]), float(t_span[1])
    xi0, xi1 = float(xi_span[0]), float(xi_span[1])
    eps_t = (t1 - t0) / (d - 1)
    deg1 = 2.0 / nse.xi_map_coeff(disc)
    eps_xi = (xi1 - xi0) / (m - 1) if m > 1 else 0.0
    a_pt = complex(np.exp(2j * xi0 * eps_t / deg1))
    w_pt = complex(np.exp(2j * eps_xi * eps_t / deg1))

    q = jnp.asarray(q)
    q_eff, r_eff, _, _ = nse.preprocess_signal(q, eps_t, kappa, disc)
    # [..., S, ups*D/S]: stage samples are interleaved per original sample,
    # so contiguous chunks align with the sharded fold's time chunks
    qs = q_eff.reshape(q_eff.shape[:-1] + (s, q_eff.shape[-1] // s))
    r = r_eff.reshape(qs.shape)
    p = transfer_matrix_coeffs(qs, r, eps_t, disc)
    tm, w = fmult2x2_tree(p, normalize=True,
                          jsym=kappa)                     # [..., S, 2, 2, c]
    c = tm.shape[-1]
    vals = chirpz(tm.reshape(tm.shape[:-3] + (4, c)), a_pt, w_pt, m)
    v = jnp.moveaxis(vals, -2, -1).reshape(tm.shape[:-3] + (m, 2, 2))
    v, w = _value_renorm(v, w)
    # same butterfly order as the sharded fold
    steps = int(math.log2(s))
    for k in range(steps):
        bit = 1 << k
        axis = -4  # the S axis of v
        idx = jnp.arange(s)
        v_in = jnp.take(v, idx ^ bit, axis=axis)
        w_in = jnp.take(w, idx ^ bit, axis=-1)
        upper = ((idx & bit) != 0)
        mine_left = jnp.einsum("...ik,...kj->...ij", v, v_in)
        mine_right = jnp.einsum("...ik,...kj->...ij", v_in, v)
        sel = upper[:, None, None, None]
        v = jnp.where(sel, mine_left, mine_right)
        v, w = _value_renorm(v, w + w_in)
    v0 = jnp.take(v, 0, axis=-4)
    w0 = jnp.take(w, 0, axis=-1)
    h11, h21 = v0[..., 0, 0], v0[..., 1, 0]
    return _apply_phase_factors(h11, h21, w0, eps_t, t0, t1, d, xi0, xi1,
                                m, kappa, disc, contspec_type)


# ---------------------------------------------------------------------------
# D-sharded KdV contspec (reference fnft_kdvv.c:129-204 semantics)
# ---------------------------------------------------------------------------

def make_dshard_kdvv_contspec(d: int, t_span, m: int, xi_span, mesh: Mesh, *,
                              disc: Discretization = Discretization.SPLIT8B,
                              seq_axis: str = "seq",
                              batch_axis: str | None = None,
                              rsym: bool = True):
    """Compile a D-sharded KdV contspec: ``u[..., D] -> rho[..., M]``.

    Same chunk-tree + value-space butterfly as :func:`make_dshard_contspec`
    but with the KdV kernel: r = -1 per sample, the real-coefficient
    (``rsym``) local trees, evaluation at the negated grid z(-xi), and the
    reference's reflection formula rho = e^{2i xi' (T1+eps/2)} H12 /
    (2i xi' H22 - H12) with xi' = -xi (fnft_kdvv.c:129-204; the 2SPLIT2A
    sqrt-z fix of :186-195).  ``rsym=False`` only if ``u`` may be complex.
    """
    if not is_fast(disc) or upsampling_factor(disc) != 1:
        raise ValueError(f"kdvv dshard supports fast ups=1 schemes; got {disc}")
    from fnft_tpu.models.kdvv import BOUNDARY_COEFF
    from fnft_tpu.parallel.sharding import as_auto_mesh
    mesh = as_auto_mesh(mesh)
    s = mesh.shape[seq_axis]
    if d % s or m % s:
        raise ValueError(f"D={d} and M={m} must be divisible by the "
                         f"'{seq_axis}' mesh size {s}")

    t0, t1 = float(t_span[0]), float(t_span[1])
    xi0, xi1 = float(xi_span[0]), float(xi_span[1])
    eps_t = (t1 - t0) / (d - 1)
    eps_xi = (xi1 - xi0) / (m - 1) if m > 1 else 0.0
    deg1 = degree(disc)
    a_pt = complex(np.exp(-2j * xi0 * eps_t / deg1))
    w_pt = complex(np.exp(-2j * eps_xi * eps_t / deg1))
    m_loc = m // s

    def body(u_loc):
        p = transfer_matrix_coeffs(u_loc, -jnp.ones_like(u_loc), eps_t, disc)
        tm, w = fmult2x2_tree(p, normalize=True, rsym=rsym)
        c = tm.shape[-1]
        flat = tm.reshape(tm.shape[:-3] + (4, c))
        vals = chirpz(flat, a_pt, w_pt, m)                # [..., 4, M]
        v = jnp.moveaxis(vals, -2, -1).reshape(tm.shape[:-3] + (m, 2, 2))
        v, w = _value_renorm(v, w)
        v, w = _butterfly_fold(v, w, seq_axis, s)
        h12, h22 = v[..., 0, 1], v[..., 1, 1]
        rdt = jnp.real(v).dtype
        xi_neg = -(xi0 + eps_xi * jnp.arange(m, dtype=rdt))
        if disc is Discretization.SPLIT2A:
            # undo the first-order-polynomial trick (fnft_kdvv.c:186-195)
            h12 = h12 / jnp.exp(1j * xi_neg * (eps_t / deg1))
        num = jnp.exp(2j * xi_neg * (t1 + BOUNDARY_COEFF * eps_t)) * h12
        rho = num / (2j * xi_neg * h22 - h12)   # shared 2^w scale cancels
        idx = jax.lax.axis_index(seq_axis)
        return {"rho": jax.lax.dynamic_slice_in_dim(rho, idx * m_loc,
                                                    m_loc, -1)}

    lead = (batch_axis,) if batch_axis is not None else ()
    in_spec = P(*lead, seq_axis)
    out_spec = P(*lead, seq_axis)
    sharded = shard_map(body, mesh=mesh, in_specs=(in_spec,),
                        out_specs=out_spec, check_vma=False)
    fn = jax.jit(sharded)

    def run(u):
        from fnft_tpu.config import complex_dtype_of
        u = jnp.asarray(u)
        u = jax.device_put(u.astype(complex_dtype_of(u)),
                           NamedSharding(mesh, in_spec))
        return fn(u)

    run.sharded_fn = fn
    run.in_sharding = NamedSharding(mesh, in_spec)
    return run


# ---------------------------------------------------------------------------
# Grid-sharded chirp-Z: each shard computes only its M/S spectral points
# ---------------------------------------------------------------------------

def chirpz_block_tables(a: complex, w: complex, n: int, m: int, s: int):
    """Host-precomputed per-block spiral start points for an M-grid split
    into S contiguous blocks: block j starts at ``a * w**(j * M/S)``.

    Returns the list of per-block ``a_j`` as Python complex (static chirp-Z
    arguments), computed in extended precision.
    """
    m_loc = m // s
    theta_w = np.longdouble(math.atan2(w.imag, w.real))
    log_w = np.longdouble(0.0 if abs(w) == 1.0 else math.log(abs(w)))
    theta_a = np.longdouble(math.atan2(a.imag, a.real))
    log_a = np.longdouble(0.0 if abs(a) == 1.0 else math.log(abs(a)))
    out = []
    for j in range(s):
        e = np.longdouble(j * m_loc)
        phase = float(np.mod(theta_a + e * theta_w, np.longdouble(2 * math.pi)))
        mag = float(np.exp(log_a + e * log_w))
        out.append(complex(mag * math.cos(phase), mag * math.sin(phase)))
    return out


def make_gridsharded_chirpz(n: int, a: complex, w: complex, m: int,
                            mesh: Mesh, *, grid_axis: str = "seq",
                            nlead: int = 0):
    """Compile an M-sharded chirp-Z: ``coeffs[..., n] -> values[..., M]``.

    The coefficients are replicated; each device evaluates **only its M/S
    block** of the spiral grid (block start points precomputed on the host
    in extended precision; ``lax.switch`` selects this device's block, so
    exactly one block's work executes per device). Per-device work is
    O((n + M/S) log) instead of O((n + M) log). Output is sharded over
    ``grid_axis``. ``nlead`` = number of leading batch axes of ``coeffs``.
    """
    from fnft_tpu.parallel.sharding import as_auto_mesh
    mesh = as_auto_mesh(mesh)
    s = mesh.shape[grid_axis]
    if m % s:
        raise ValueError(f"M={m} must be divisible by mesh axis size {s}")
    m_loc = m // s
    a_blocks = chirpz_block_tables(a, w, n, m, s)

    def body(coeffs):
        idx = jax.lax.axis_index(grid_axis)
        branches = [partial(chirpz, a=a_blocks[j], w=w, m=m_loc)
                    for j in range(s)]
        return jax.lax.switch(idx, branches, coeffs)

    sharded = shard_map(body, mesh=mesh, in_specs=(P(*([None] * nlead), None),),
                        out_specs=P(*([None] * nlead), grid_axis),
                        check_vma=False)
    return jax.jit(sharded)
