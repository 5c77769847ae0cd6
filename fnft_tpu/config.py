"""Precision and compile-cache configuration.

The reference library (fnft_numtypes.h:40-62) fixes FNFT_COMPLEX = double
complex. This rebuild is dtype polymorphic instead: every kernel infers its
working dtype from the input signal's dtype, so a caller opts into a
precision simply by casting ``q``. complex128 (enable with :func:`use_x64`)
is the precision the reference's error bounds are stated for, on the CPU
and on the GPU alike; complex64 is a separate, lower-accuracy contract.
"""

from __future__ import annotations

import os
import pathlib

import jax
import jax.numpy as jnp

_CHECKOUT = pathlib.Path(__file__).resolve().parents[1]


def use_x64(enable: bool = True) -> None:
    """Enable float64/complex128 globally (wraps jax.config)."""
    jax.config.update("jax_enable_x64", enable)


def compilation_cache_dir() -> str:
    """Where compiled programs persist: ``$JAX_COMPILATION_CACHE_DIR`` when
    set, else the fixed ``<checkout>/.jax_cache`` (a fixed path, because
    the path is part of the cache key)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        _CHECKOUT / ".jax_cache")


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compile cache at
    :func:`compilation_cache_dir` and return that directory. With
    ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it and no other
    directory is set here."""
    path = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def default_complex_dtype():
    """complex128 when x64 is on, else complex64."""
    return jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64


def real_dtype_of(cdtype) -> jnp.dtype:
    """Real dtype paired with a complex dtype."""
    return jnp.finfo(cdtype).dtype


def complex_dtype_of(x) -> jnp.dtype:
    """Working complex dtype inferred from an array's dtype."""
    dt = jnp.result_type(x)
    if dt == jnp.complex128 or dt == jnp.float64:
        return jnp.dtype(jnp.complex128)
    return jnp.dtype(jnp.complex64)


def eps_of(dtype) -> float:
    """Machine epsilon of the real part of ``dtype``."""
    return float(jnp.finfo(dtype).eps)
