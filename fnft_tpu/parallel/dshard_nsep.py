"""Time-axis (D) sharding of the nsep refinement pipeline.

The reference's periodic driver refines every candidate main/aux spectrum
point with Newton sweeps over the FULL signal (refine_mainspec /
refine_auxspec, src/fnft_nsep.c:707-835): each iteration evaluates the
complete monodromy matrix (and its lambda-derivative) — a sequential
O(D) recursion per candidate in C. At D = 2^20 this refinement dominates
the nsep runtime; it is exactly the part multi-chip should carry.

Design (mirrors parallel/dshard_boundstates.py):

* the D (effective) samples are split into S contiguous time chunks, one
  per device on the ``seq`` mesh axis;
* each device reduces its chunk to one (T, T') transfer matrix per
  candidate via log-depth local products — O(D/S) per device;
* the S chunk matrices ([S, K, 2, 2] — a few KiB for K candidates) meet
  in a single ``all_gather`` across the devices and every device composes the
  total monodromy locally;
* the entire Newton sweep (the reference's m in {1,2} line-search for
  the main spectrum, plain Newton on T12 for the aux spectrum) runs as
  ONE XLA program (lax.fori_loop) inside shard_map — one collective per
  sweep, no host round-trips.

The subsampled localization stage (fast monodromy + batched Aberth)
stays replicated: its cost is O(Dsub^2), Dsub ~ sqrt(D log^2 D),
independent of the full-D axis this module shards.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from fnft_tpu.models.discretization import Discretization, upsampling_factor
from fnft_tpu.ops.scatter import (
    _family_inputs,
    _pair_combine,
)
from fnft_tpu.parallel.dshard_boundstates import _local_products


def _total_monodromy(q_loc, r_loc, lam, eps_t, disc, seq_axis):
    """(T, T') of the full monodromy at candidates ``lam [K]``, composed
    from per-device chunk products with one all_gather (cf.
    nse_scatter_matrix semantics: ops/scatter.scatter_matrix)."""
    xs_loc, step_fn, scl = _family_inputs(q_loc, r_loc, eps_t, disc)
    m_loc, dm_loc = _local_products(xs_loc, step_fn, lam, True)
    gm = jax.lax.all_gather(m_loc, seq_axis)       # [S, K, 2, 2]
    gdm = jax.lax.all_gather(dm_loc, seq_axis)
    pm, pd = jax.lax.associative_scan(_pair_combine, (gm, gdm), axis=0)
    return pm[-1], pd[-1] * scl


def make_dshard_nsep_refine(d: int, mesh: Mesh, *, eps_t: float,
                            base_disc: Discretization,
                            iters_main: int, iters_aux: int,
                            seq_axis: str = "seq"):
    """Compile D-sharded nsep Newton refinement.

    Returns ``(refine_main, refine_aux)``:

    * ``refine_main(q_eff, r_eff, lam0 [K], rhs [K], tol) -> lam [K]`` —
      the reference's higher-order-root Newton with m in {1, 2} line
      search on Delta(lam) + rhs (refine_mainspec, fnft_nsep.c:707-793;
      the single-device twin is models/nsep._refine_mainspec_loop).
    * ``refine_aux(q_eff, r_eff, lam0 [K], tol) -> lam [K]`` — plain
      Newton on T12 (refine_auxspec, fnft_nsep.c:796-835).

    ``q_eff``/``r_eff`` are sharded over ``seq_axis``; candidates are
    replicated (they are O(K) scalars).
    """
    from fnft_tpu.parallel.sharding import as_auto_mesh

    mesh = as_auto_mesh(mesh)
    s = mesh.shape[seq_axis]
    ups = upsampling_factor(base_disc)
    d_eff = d * ups
    if d_eff % s or (d_eff // s) % ups:
        raise ValueError(
            f"D_eff={d_eff} must split into {s} whole-sample chunks")

    # the Newton bodies (m in {1,2} line search, per-root freezing) are
    # shared with the single-device driver; only the monodromy evaluator
    # differs (chunk products + all_gather instead of full scatter_matrix)
    from fnft_tpu.models.nsep import _auxspec_newton_sweep, _mainspec_newton_sweep

    def main_body(q_loc, r_loc, lam0, rhs, tol):
        def floquet(lam):
            t, td = _total_monodromy(q_loc, r_loc, lam, eps_t, base_disc,
                                     seq_axis)
            return (t[:, 0, 0] + t[:, 1, 1]), (td[:, 0, 0] + td[:, 1, 1])

        return _mainspec_newton_sweep(floquet, lam0, rhs, tol, iters_main)

    def aux_body(q_loc, r_loc, lam0, tol):
        def evalb(lam):
            t, td = _total_monodromy(q_loc, r_loc, lam, eps_t, base_disc,
                                     seq_axis)
            return t[:, 0, 1], td[:, 0, 1]

        return _auxspec_newton_sweep(evalb, lam0, tol, iters_aux)

    spec_seq = P(seq_axis)
    rep = P()
    main_fn = jax.jit(shard_map(
        main_body, mesh=mesh,
        in_specs=(spec_seq, spec_seq, rep, rep, rep),
        out_specs=rep, check_vma=False))
    aux_fn = jax.jit(shard_map(
        aux_body, mesh=mesh,
        in_specs=(spec_seq, spec_seq, rep, rep),
        out_specs=rep, check_vma=False))

    def _put(q_eff, r_eff):
        sh = NamedSharding(mesh, spec_seq)
        return (jax.device_put(jnp.asarray(q_eff), sh),
                jax.device_put(jnp.asarray(r_eff), sh))

    def refine_main(q_eff, r_eff, lam0, rhs, tol):
        q_eff, r_eff = _put(q_eff, r_eff)
        return main_fn(q_eff, r_eff, jnp.asarray(lam0), jnp.asarray(rhs),
                       jnp.asarray(tol))

    def refine_aux(q_eff, r_eff, lam0, tol):
        q_eff, r_eff = _put(q_eff, r_eff)
        return aux_fn(q_eff, r_eff, jnp.asarray(lam0), jnp.asarray(tol))

    refine_main.sharded_fn = main_fn
    refine_aux.sharded_fn = aux_fn
    return refine_main, refine_aux


def dshard_nsep_reference(q, t_span, mesh, *, kappa: int = +1,
                          phase_shift: float = 0.0, opts=None,
                          want_main: bool = True, want_aux: bool = True,
                          skip_real: bool = False, seq_axis: str = "seq"):
    """Full D-sharded nsep SUBSAMPLE_AND_REFINE (reference semantics:
    fnft_nsep.c:441-705 + refine loops :707-835).

    The subsampled localization (fast monodromy tree + one batched
    Aberth dispatch over all spines) runs replicated — its cost does not
    scale with D — and the full-D Newton refinement runs sharded over
    ``seq_axis``. Returns ``(main, aux)`` as filtered numpy arrays,
    directly comparable to ``models.nsep.nsep`` with
    ``Localization.SUBSAMPLE_AND_REFINE``.
    """
    from fnft_tpu.models import nsep as m
    from fnft_tpu.models.discretization import degree, z_to_lambda
    from fnft_tpu.ops.fscatter import fscatter
    from fnft_tpu.ops.roots import (certified_tol, poly_roots_batched,
                                    root_residuals)

    opts = opts or m.NsepOpts()
    q = jnp.asarray(q)
    d = q.shape[-1]
    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / d        # periodic grid: no endpoint duplication
    lam_shift = phase_shift / (-2.0 * (t1 - t0))
    rdt = jnp.real(q).dtype
    tgrid = t0 + eps_t * jnp.arange(d, dtype=rdt)
    q_pre = q * jnp.exp(2j * lam_shift * tgrid)

    box = list(opts.bounding_box)
    if opts.filtering is m.PointFilter.MANUAL:
        box[0] -= lam_shift
        box[1] -= lam_shift
    box = tuple(box)

    # replicated subsampled localization — shared with the single-device
    # driver (models.nsep._sr_localize); only the full-D Newton refinement
    # below runs sharded
    lam_cat, rhs_cat, aux_lam, ctx = m._sr_localize(
        q_pre, eps_t, d, kappa, box, opts, want_main, want_aux, skip_real)
    q_eff, r_eff = ctx["q_eff"], ctx["r_eff"]
    post_filter = ctx["post_filter"]
    base = ctx["base"]
    refine_tol = ctx["refine_tol"]
    # max_evals == 0 disables refinement entirely, matching the
    # single-device contract (models.nsep._refine_mainspec/_refine_auxspec)
    refine = opts.max_evals > 0
    iters = max(1, (opts.max_evals - 1) // 2)

    refine_main, refine_aux = (make_dshard_nsep_refine(
        d, mesh, eps_t=eps_t, base_disc=base,
        iters_main=iters, iters_aux=opts.max_evals, seq_axis=seq_axis)
        if refine else (None, None))

    main = aux = None
    if lam_cat is not None:
        if lam_cat.size and refine:
            lam_ref = refine_main(q_eff, r_eff, jnp.asarray(lam_cat),
                                  jnp.asarray(rhs_cat), refine_tol)
            main = post_filter(np.asarray(lam_ref))
        elif lam_cat.size:
            main = post_filter(np.asarray(lam_cat))
        else:
            main = lam_cat
    if aux_lam is not None:
        if aux_lam.size and refine:
            aux_lam = np.asarray(refine_aux(q_eff, r_eff,
                                            jnp.asarray(aux_lam),
                                            refine_tol))
        aux = post_filter(aux_lam)
    if main is not None:
        main = main + lam_shift
    if aux is not None:
        aux = aux + lam_shift
    return main, aux
