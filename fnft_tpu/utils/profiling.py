"""Tracing/profiling hooks (SURVEY.md section 5.1).

The reference has only #ifdef DEBUG printfs; here the native JAX tooling is
exposed with thin helpers so every driver stage shows up named in device
profiles (Perfetto/XProf).
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def named_scope(name: str):
    """Annotate a region for the device profiler."""
    with jax.named_scope(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace viewable in XProf/TensorBoard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def wallclock(label: str, sink=print):
    """Host-side wall-clock timer with block_until_ready semantics left to
    the caller (device work is asynchronous)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sink(f"[fnft-tpu] {label}: {time.perf_counter() - t0:.4f}s")
