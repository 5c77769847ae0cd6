"""Time-axis (D) sharding of the discrete-spectrum pipeline.

The reference's expensive bound-state path (src/fnft_nsev.c:595-741) is a
subsampled eigenvalue problem followed by ``niter`` full-D Newton sweeps,
each a sequential phi-recursion over all D samples plus a phi/psi pair for
the norming constants (fnft__nse_scatter_bound_states.c:29-668). The sharded
version distributes exactly the part that scales with D:

* the D (effective) samples are split into S contiguous time chunks, one
  per device on the ``seq`` mesh axis;
* each device reduces its chunk to a single transfer matrix (with
  lambda-derivative) via log-depth local products — the O(D) work is
  perfectly work-partitioned;
* the S chunk matrices ([S, K, 2, 2] for K bound states — a few KiB) are
  combined with one ``all_gather`` across the devices; every device then composes
  the prefix/suffix products it needs locally. A ppermute butterfly would
  also work, but for K ~ 10 bound states the gathered tensor is so small
  that a single collective is strictly cheaper than log2(S) exchanges;
* the whole ``niter``-sweep Newton refinement runs as ONE XLA program
  (lax.fori_loop) inside shard_map: no host round-trips, one collective
  per sweep;
* the final norming-constant pass re-derives per-sample phi/psi values
  locally from the device-edge states and reduces the b error-metric
  argmin (DOI 10.1109/ACCESS.2019.2932256) with a second tiny gather.

The subsampled Aberth localization stage stays replicated: its cost is
O(Dsub^2) with Dsub = sqrt(D log^2 D), independent of the full-D axis
this module shards.

Restrictions: the Newton base discretizations (CF family incl. BO) with
q_eff length divisible by S * upsampling_factor.
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

from fnft_tpu.config import complex_dtype_of, eps_of
from fnft_tpu.models import nse
from fnft_tpu.models.discretization import Discretization, upsampling_factor
from fnft_tpu.ops.scatter import (
    BOUNDARY_COEFF,
    _all_step_matrices,
    _family_inputs,
    _mat_scan,
    _pair_combine,
    _tree_product,
)


def _local_products(xs_loc, step_fn, lam, derivative: bool):
    """Reduce this device's chunk to one (T, T') transfer matrix.

    Sub-chunks of <= 4096 steps keep the [n, K, 2, 2] stacks small;
    log-depth products inside each sub-chunk, associative scan across.
    """
    s_loc = jax.tree.leaves(xs_loc)[0].shape[0]
    sub = min(s_loc, 4096)
    while s_loc % sub:
        sub //= 2
    c_num = s_loc // sub
    xs_c = jax.tree.map(
        lambda a_: a_.reshape((c_num, sub) + a_.shape[1:]), xs_loc)

    def one_chunk(xc):
        u, du = _all_step_matrices(xc, step_fn, lam, derivative=derivative)
        return _tree_product(u, du if derivative else None)

    ms, dms = jax.lax.map(one_chunk, xs_c)
    pm, pd = jax.lax.associative_scan(_pair_combine, (ms, dms), axis=0)
    return pm[-1], pd[-1]


def _local_backward_product(xs_loc, step_fn, lam):
    """Backward (psi) product of this device's chunk, later steps right."""
    xs_rev = jax.tree.map(lambda a_: a_[::-1], xs_loc)

    def one(x):
        ub, _ = step_fn(lam, x[0], x[1], x[2], derivative=False,
                        backward=True)
        return ub

    s_loc = jax.tree.leaves(xs_rev)[0].shape[0]
    sub = min(s_loc, 4096)
    while s_loc % sub:
        sub //= 2
    c_num = s_loc // sub
    xs_c = jax.tree.map(
        lambda a_: a_.reshape((c_num, sub) + a_.shape[1:]), xs_rev)

    def one_chunk(xc):
        m, _ = _tree_product(jax.vmap(one)(xc), None)
        return m

    wb = jax.lax.map(one_chunk, xs_c)
    return _mat_scan(wb)[-1]


def _exclusive_prefix(gm, gdm, idx):
    """Product of chunks 0..idx-1 (identity at idx=0) from gathered
    chunk matrices ``gm[S, K, 2, 2]`` — computed redundantly on every
    device (S is tiny)."""
    s = gm.shape[0]
    eye = jnp.broadcast_to(jnp.eye(2, dtype=gm.dtype), gm.shape[1:])
    pm, pd = jax.lax.associative_scan(_pair_combine, (gm, gdm), axis=0)
    pm_ex = jnp.concatenate([eye[None], pm[:-1]], axis=0)
    pd_ex = jnp.concatenate([jnp.zeros_like(eye)[None], pd[:-1]], axis=0)
    return pm_ex[idx], pd_ex[idx], pm[-1], pd[-1]


def make_dshard_boundstates(d: int, t_span, mesh: Mesh, *, kappa: int = +1,
                            disc: Discretization = Discretization.BO,
                            niter: int = 10, seq_axis: str = "seq"):
    """Compile the D-sharded bound-state refinement + norming constants.

    Returns a jitted function ``(q_eff, r_eff, lam0, box) -> (lam, a,
    aprime, b)`` with ``q_eff``/``r_eff`` sharded over ``seq_axis`` and
    everything else replicated. ``lam0 [K]`` are the (subsampled-stage)
    initial bound states; ``box [4]`` is the Newton bounding box
    (reference fnft_nsev.c:973-1038 freeze/leave semantics).
    """
    from fnft_tpu.parallel.sharding import as_auto_mesh

    mesh = as_auto_mesh(mesh)
    s = mesh.shape[seq_axis]
    ups = upsampling_factor(disc)
    d_eff = d * ups
    if d % s or d_eff % s:
        raise ValueError(f"D={d} must be divisible by mesh axis size {s}")
    if (d_eff // s) % ups:
        raise ValueError("per-device chunk must hold whole samples")

    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / (d - 1)
    tb = t0 - eps_t * BOUNDARY_COEFF
    te = t1 + eps_t * BOUNDARY_COEFF
    store_every = ups

    def body(q_loc, r_loc, lam0, box):
        idx = jax.lax.axis_index(seq_axis)
        cdt = q_loc.dtype
        eprec = 100.0 * eps_of(cdt)

        def a_ap(lam):
            xs_loc, step_fn, scl = _family_inputs(q_loc, r_loc, eps_t, disc)
            m_loc, dm_loc = _local_products(xs_loc, step_fn, lam, True)
            gm = jax.lax.all_gather(m_loc, seq_axis)     # [S, K, 2, 2]
            gdm = jax.lax.all_gather(dm_loc, seq_axis)
            _, _, tot_m, tot_d = _exclusive_prefix(gm, gdm, idx)
            phi0 = jnp.stack([jnp.exp(-1j * lam * tb),
                              jnp.zeros_like(lam)], axis=-1)
            dphi0 = jnp.stack([phi0[:, 0] * (-1j * tb),
                               jnp.zeros_like(lam)], axis=-1)
            phi_end = jnp.einsum("kij,kj->ki", tot_m, phi0)
            dphi_end = jnp.einsum("kij,kj->ki", tot_d, phi0) + \
                jnp.einsum("kij,kj->ki", tot_m, dphi0)
            a = phi_end[:, 0] * jnp.exp(1j * lam * te)
            ap = scl * (dphi_end[:, 0] * jnp.exp(1j * lam * te) +
                        (1j * te) * a)
            return a, ap

        # ---- Newton refinement: one fori_loop, one gather per sweep ----
        def newton_body(_, carry):
            lam, active = carry
            a, ap = a_ap(lam)
            step = a / jnp.where(ap == 0, 1.0, ap)
            step = jnp.where((a == 0) | (ap == 0), 0.0, step)
            lam_new = jnp.where(active, lam - step, lam)
            in_box = ((jnp.real(lam_new) >= box[0])
                      & (jnp.real(lam_new) <= box[1])
                      & (jnp.imag(lam_new) >= box[2])
                      & (jnp.imag(lam_new) <= box[3]))
            active = active & (jnp.abs(step) > eprec) & in_box
            return lam_new, active

        lam, _ = jax.lax.fori_loop(
            0, niter, newton_body,
            (lam0, jnp.ones(lam0.shape, dtype=bool)))

        # ---- final pass: a, a', b at the refined states -----------------
        xs_loc, step_fn, scl = _family_inputs(q_loc, r_loc, eps_t, disc)
        m_loc, dm_loc = _local_products(xs_loc, step_fn, lam, True)
        gm = jax.lax.all_gather(m_loc, seq_axis)
        gdm = jax.lax.all_gather(dm_loc, seq_axis)
        pm_ex, pd_ex, tot_m, tot_d = _exclusive_prefix(gm, gdm, idx)

        phi0 = jnp.stack([jnp.exp(-1j * lam * tb),
                          jnp.zeros_like(lam)], axis=-1)
        dphi0 = jnp.stack([phi0[:, 0] * (-1j * tb),
                           jnp.zeros_like(lam)], axis=-1)
        psi_end = jnp.stack([jnp.zeros_like(lam),
                             jnp.exp(1j * lam * te)], axis=-1)
        phi_end = jnp.einsum("kij,kj->ki", tot_m, phi0)
        dphi_end = jnp.einsum("kij,kj->ki", tot_d, phi0) + \
            jnp.einsum("kij,kj->ki", tot_m, dphi0)
        a = phi_end[:, 0] * jnp.exp(1j * lam * te)
        aprime = scl * (dphi_end[:, 0] * jnp.exp(1j * lam * te) +
                        (1j * te) * a)

        # device-edge states: phi at my left edge, psi at my right edge
        phi_left = jnp.einsum("kij,kj->ki", pm_ex, phi0)
        wb_loc = _local_backward_product(xs_loc, step_fn, lam)
        gwb = jax.lax.all_gather(wb_loc, seq_axis)       # [S, K, 2, 2]
        # psi_right(i) = Wb(i+1) @ ... @ Wb(S-1) applied to psi_end:
        # scan gathered backward products from the last chunk leftward
        eye = jnp.broadcast_to(jnp.eye(2, dtype=cdt), gwb.shape[1:])
        qm = _mat_scan(gwb[::-1])                        # [S, K, 2, 2]
        qm_ex = jnp.concatenate([eye[None], qm[:-1]], axis=0)[::-1]
        psi_right = jnp.einsum("kij,kj->ki", qm_ex[idx], psi_end)

        # local per-sample trajectories from the edge states
        u, _ = _all_step_matrices(xs_loc, step_fn, lam, derivative=False)
        lp = _mat_scan(u)
        phi_vals = jnp.einsum("skij,kj->ski", lp, phi_left)
        xs_rev = jax.tree.map(lambda a_: a_[::-1], xs_loc)

        def one_b(x):
            ub, _ = step_fn(lam, x[0], x[1], x[2], derivative=False,
                            backward=True)
            return ub

        rb = _mat_scan(jax.vmap(one_b)(xs_rev))
        psi_rev = jnp.einsum("skij,kj->ski", rb, psi_right)
        psi_vals = jnp.concatenate([psi_rev[::-1][1:], psi_right[None]],
                                   axis=0)
        phi_s = phi_vals[store_every - 1::store_every]
        psi_s = psi_vals[store_every - 1::store_every]
        # device 0 also contributes the T[0] boundary sample (reference
        # stores phi at D+1 grid points, incl. the left boundary)
        first = (idx == 0)
        phi_s = jnp.concatenate([
            jnp.where(first, phi0, phi_s[0])[None], phi_s], axis=0)
        psi0_dev = jnp.einsum("kij,kj->ki", rb[-1], psi_right)
        psi_s = jnp.concatenate([
            jnp.where(first, psi0_dev, psi_s[0])[None], psi_s], axis=0)

        ratio = (phi_s[..., 1] / psi_s[..., 1]) / \
                (phi_s[..., 0] / psi_s[..., 0])
        metric = jnp.abs(0.5 * jnp.log(jnp.abs(ratio)))
        metric = jnp.where(jnp.isnan(metric), jnp.inf, metric)
        j = jnp.argmin(metric, axis=0)
        m_best = jnp.take_along_axis(metric, j[None, :], axis=0)[0]
        b_best = jnp.take_along_axis(
            phi_s[..., 0], j[None, :], axis=0)[0] / jnp.take_along_axis(
            psi_s[..., 0], j[None, :], axis=0)[0]

        # global argmin over devices (tiny [S, K] gathers)
        gmet = jax.lax.all_gather(m_best, seq_axis)      # [S, K]
        gb = jax.lax.all_gather(b_best, seq_axis)
        jdev = jnp.argmin(gmet, axis=0)
        b = jnp.take_along_axis(gb, jdev[None, :], axis=0)[0]
        return lam, a, aprime, b

    spec_seq = P(seq_axis)
    rep = P()
    sharded = shard_map(
        body, mesh=mesh,
        in_specs=(spec_seq, spec_seq, rep, rep),
        out_specs=(rep, rep, rep, rep), check_vma=False)
    fn = jax.jit(sharded)

    def run(q_eff, r_eff, lam0, box):
        q_eff = jax.device_put(jnp.asarray(q_eff),
                               NamedSharding(mesh, spec_seq))
        r_eff = jax.device_put(jnp.asarray(r_eff),
                               NamedSharding(mesh, spec_seq))
        return fn(q_eff, r_eff, jnp.asarray(lam0), jnp.asarray(box))

    run.sharded_fn = fn
    return run


def dshard_boundstates_reference(q, t_span, mesh, *, kappa: int = +1,
                                 disc: Discretization = Discretization.SPLIT4B,
                                 niter: int = 10, dsub: int = 0,
                                 seq_axis: str = "seq"):
    """Full D-sharded discrete spectrum of ``q`` (reference semantics:
    fnft_nsev.c:595-741 SUBSAMPLE_AND_REFINE + norming constants).

    The subsampled Aberth localization runs replicated (its cost does not
    scale with the full D); the full-D Newton sweeps and the norming-
    constant phi/psi pass run sharded over ``seq_axis``. Returns
    ``(bound_states, norming_constants)`` as numpy arrays (filtered).
    """
    import fnft_tpu.models.nsev as nsev_mod

    q = jnp.asarray(q)
    d = q.shape[-1]
    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / (d - 1)
    base = nse.newton_base_discretization(disc)

    # replicated subsampled localization (fast eigenvalue at Dsub)
    dsub = dsub or int(math.sqrt(d * math.log2(d) ** 2))
    qs_eff, rs_eff, dsub_act, (i0, i1) = nse.preprocess_signal(
        q, eps_t, kappa, disc, dsub)
    ts0, ts1 = t0 + i0 * eps_t, t0 + i1 * eps_t
    sub = nsev_mod._nsev_base(qs_eff, rs_eff, q, ts0, ts1, 0, -1.0, 1.0,
                              kappa, nsev_mod.NsevOpts(discretization=disc),
                              nsev_mod.BoundStateLocalization.FAST_EIGENVALUE,
                              None, False, True)
    lam0 = np.asarray(sub.bound_states)
    if lam0.size == 0:
        return lam0, np.zeros(0, complex)

    deg1 = max(1, nsev_mod.degree(disc))
    map_coeff = 2.0 / deg1
    box = (-nsev_mod._re_bound(eps_t, map_coeff),
           nsev_mod._re_bound(eps_t, map_coeff),
           0.0, nsev_mod._im_bound(q, t0, t1))

    q_eff, r_eff, _, _ = nse.preprocess_signal(q, eps_t, kappa, base)
    fn = make_dshard_boundstates(d, t_span, mesh, kappa=kappa, disc=base,
                                 niter=niter, seq_axis=seq_axis)
    lam, a, ap, b = fn(q_eff, r_eff, lam0, box)
    lam, b = np.asarray(lam), np.asarray(b)

    from fnft_tpu.utils import misc

    mask = misc.filter_mask(jnp.asarray(lam), box)
    mask = misc.merge_mask(jnp.asarray(lam),
                           misc.merge_tol_default(np.complex128), mask)
    keep = np.asarray(mask)
    return lam[keep], b[keep]
