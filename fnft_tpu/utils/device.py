"""Device checks for measurement scripts (chip_smoke.py, bench.py).

A measurement names the device it ran on and never falls back to another:
:func:`require_gpu` raises when JAX finds no GPU.
"""

from __future__ import annotations

import subprocess

import jax


class NoGpuError(RuntimeError):
    """JAX's first device is not a GPU."""


def require_gpu():
    """Return ``jax.devices()[0]``; raise :class:`NoGpuError` unless it is
    a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise NoGpuError(f"a GPU is required; JAX's first device is "
                         f"{dev.platform} ({dev.device_kind})")
    return dev


def card_info() -> str:
    """``name, power.limit`` of the first GPU as nvidia-smi reports them
    (a subprocess that never touches JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def peak_bytes_in_use(dev) -> int | None:
    """``peak_bytes_in_use`` of ``dev``'s allocator (None where the backend
    keeps no memory statistics)."""
    stats = dev.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")
