"""Host-precomputed table registry: constants at trace time OR jit params.

The matmul FFT path (ops/mxu_fft.py) and the real-lowered pipeline
(ops/tpu_pipeline.py) rely on host-precomputed f32 tables (DFT matrices,
twiddle factors, chirp-Z spirals).  Closing over them inside ``jax.jit``
inlines every table into the StableHLO payload as a literal — at D=2^20
the flagship pipeline's tables total >200 MB of MLIR, which makes the
compile slow and memory-hungry.

``jit_tabled`` fixes this by tracing the function twice:

1. a collection pass (``jax.eval_shape``, no FLOPs) records every table
   the function requests through :func:`get`;
2. the real ``jax.jit`` traces a wrapper whose extra argument is the
   tuple of tables, and :func:`get` hands out the *traced* arrays.

Tables are uploaded to the device once at build time and passed by
reference on every call, so the compiled payload contains no big
literals.  Outside ``jit_tabled`` (plain ``jax.jit`` or eager), ``get``
degrades to the old inline-constant behavior.
"""

from __future__ import annotations

import threading
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

_STATE = threading.local()


def _collecting() -> dict | None:
    return getattr(_STATE, "collect", None)


def _params() -> dict | None:
    return getattr(_STATE, "params", None)


def get(key: tuple, builder):
    """Return the table for ``key`` as a tuple of jnp arrays.

    ``builder()`` must return a tuple of host numpy arrays and be
    deterministic per key (keys are (name, *static_config)).
    """
    params = _params()
    if params is not None:
        if key in params:
            return params[key]
        # table requested only in the real trace (e.g. shape-dependent
        # branch the abstract pass didn't take) — fall through to inline
    collect = _collecting()
    if collect is not None and key not in collect:
        collect[key] = tuple(np.asarray(a) for a in builder())
    host = collect[key] if collect is not None else builder()
    return tuple(jnp.asarray(a) for a in host)


class _Ctx:
    def __init__(self, attr, value):
        self.attr, self.value = attr, value

    def __enter__(self):
        setattr(_STATE, self.attr, self.value)
        return self.value

    def __exit__(self, *exc):
        setattr(_STATE, self.attr, None)


def jit_tabled(fn, example_args, static_argnums=()):
    """``jax.jit(fn)`` with all registry tables passed as parameters.

    ``example_args``: abstract or concrete arrays matching the call
    signature (used for the collection pass only).  Returns a callable
    with the same signature as ``fn``; tables live on the default device
    for the lifetime of the returned closure.
    """
    collect: dict = {}
    with _Ctx("collect", collect):
        jax.eval_shape(fn, *example_args)
    keys = tuple(collect.keys())
    tables_dev = tuple(
        tuple(jax.device_put(jnp.asarray(a)) for a in collect[k])
        for k in keys)

    def wrapped(args, tables):
        with _Ctx("params", dict(zip(keys, tables))):
            return fn(*args)

    inner = jax.jit(wrapped)

    def call(*args):
        return inner(args, tables_dev)

    call.n_tables = len(keys)  # introspection for tests
    call.table_bytes = int(sum(a.size * a.dtype.itemsize
                               for k in keys for a in collect[k]))
    return call
