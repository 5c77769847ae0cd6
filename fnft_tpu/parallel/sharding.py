"""Multi-device execution: batch and spectral-grid sharding.

The reference is single-threaded C (SURVEY.md section 2.8); parallelism is a
first-class capability of this rebuild instead:

* **batch parallelism** — a stack of signals vmaps across examples and
  shards over the ``"batch"`` mesh axis (data parallel),
* **grid parallelism** — the M-point chirp-Z evaluation is embarrassingly
  parallel and shards over the ``"grid"`` axis,
* the fmult tree's early levels are local to the batch shard; XLA inserts
  cross-device collectives only where sharded axes meet.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fnft_tpu.models.discretization import Discretization
from fnft_tpu.models import nse
from fnft_tpu.models.nsev import ContspecType, NsevOpts, _apply_phase_factors, _contspec_eval
from fnft_tpu.ops.fscatter import fscatter


def as_auto_mesh(mesh):
    """Normalize a user mesh to Auto axis types.

    ``jax.make_mesh`` defaults to Explicit sharding axes on jax >= 0.9;
    this package's data-parallel entry points use sharding propagation
    (Auto semantics), so an Explicit mesh from a user is rebuilt with the
    same devices and names but Auto axis types. No-op for Auto meshes.
    """
    if mesh is None:
        return None
    try:
        from jax.sharding import AxisType

        if all(t == AxisType.Auto for t in mesh.axis_types):
            return mesh
    except ImportError:  # older jax: no axis types, nothing to normalize
        return mesh
    return Mesh(mesh.devices, mesh.axis_names)


def make_mesh(devices=None, axis_names=("batch",)):
    """A device mesh over all available devices.

    Multi-axis meshes factor the device count into near-square factors
    (largest divisor <= sqrt(n) on the trailing axis), so non-perfect-power
    counts like 8 devices on 2 axes give a (4, 2) mesh.
    """
    import numpy as np

    devices = devices if devices is not None else jax.devices()
    devs = np.asarray(devices)
    n_axes = len(axis_names)
    if n_axes > 1:
        shape = []
        remaining = len(devs)
        for _ in range(n_axes - 1):
            s = 1
            for cand in range(1, int(remaining ** 0.5) + 1):
                if remaining % cand == 0:
                    s = cand
            shape.append(remaining // s)
            remaining = s
        shape.append(remaining)
        devs = devs.reshape(tuple(shape))
    return Mesh(devs, axis_names)


def make_nsev_batch_fn(d: int, t_span, m: int, xi_span, *, kappa: int = +1,
                       disc: Discretization = Discretization.SPLIT4B,
                       contspec_type=None, mesh: Mesh | None = None):
    """Compile a reusable batched forward-NFT function q[B, D] -> spectra.

    The returned callable is jitted once per (D, M, grid) geometry and
    returns a dict with 'rho' (and 'a', 'b' when contspec_type is AB/BOTH).
    With a mesh, inputs/outputs shard over the 'batch' axis. This is the
    production serving entry point: feed batches from
    :func:`fnft_tpu.native.read_signal_batch` and keep the device busy.
    """
    from fnft_tpu.models.nsev import ContspecType

    contspec_type = contspec_type or ContspecType.REFLECTION_COEFFICIENT
    mesh = as_auto_mesh(mesh)
    t0, t1 = float(t_span[0]), float(t_span[1])
    xi0, xi1 = float(xi_span[0]), float(xi_span[1])
    eps_t = (t1 - t0) / (d - 1)

    def single(q):
        q_eff, r_eff, _, _ = nse.preprocess_signal(q, eps_t, kappa, disc)
        tm, w = fscatter(q_eff, r_eff, eps_t, disc, jsym=kappa)
        h11, h21, w_ = _contspec_eval(tm, w, q_eff, r_eff, eps_t, t0, t1,
                                      d, xi0, xi1, m, disc)
        return _apply_phase_factors(h11, h21, w_, eps_t, t0, t1, d, xi0,
                                    xi1, m, kappa, disc, contspec_type)

    jitted = jax.jit(jax.vmap(single))
    if mesh is not None:
        sharding = NamedSharding(mesh, P("batch", None))

        def run(q_batch):
            # input sharding propagates through the whole batched program
            return jitted(jax.device_put(jnp.asarray(q_batch), sharding))

        return run
    return jitted


def batched_nsev_contspec(q_batch, t_span, m: int, xi_span, *, kappa: int = +1,
                          disc: Discretization = Discretization.SPLIT4B,
                          mesh: Mesh | None = None):
    """Reflection coefficients of a batch of signals, sharded over a mesh.

    ``q_batch`` has shape [B, D]; the batch axis is sharded over the mesh's
    "batch" axis. Returns rho with shape [B, M].
    """
    mesh = as_auto_mesh(mesh)
    t0, t1 = float(t_span[0]), float(t_span[1])
    xi0, xi1 = float(xi_span[0]), float(xi_span[1])
    d = q_batch.shape[-1]
    eps_t = (t1 - t0) / (d - 1)

    def single(q):
        q_eff, r_eff, _, _ = nse.preprocess_signal(q, eps_t, kappa, disc)
        tm, w = fscatter(q_eff, r_eff, eps_t, disc, jsym=kappa)
        h11, h21, w_ = _contspec_eval(tm, w, q_eff, r_eff, eps_t, t0, t1,
                                      d, xi0, xi1, m, disc)
        cs = _apply_phase_factors(h11, h21, w_, eps_t, t0, t1, d, xi0, xi1,
                                  m, kappa, disc,
                                  ContspecType.REFLECTION_COEFFICIENT)
        return cs["rho"]

    fn = jax.jit(jax.vmap(single))
    if mesh is not None:
        sharding = NamedSharding(mesh, P("batch", None))
        q_batch = jax.device_put(q_batch, sharding)
        fn = jax.jit(jax.vmap(single), out_shardings=NamedSharding(mesh, P("batch", None)))
    return fn(q_batch)
