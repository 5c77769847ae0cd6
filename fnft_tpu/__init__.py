"""fnft-tpu: fast (inverse) nonlinear Fourier transforms in JAX.

A from-scratch JAX/XLA re-design of the capabilities of FNFT (reference:
IgorChekhovskoy/FNFT, a single-threaded C99 library). The public API
mirrors the reference's driver surface (``include/fnft_nsev.h`` etc. in
the reference for the C originals):

* :func:`nsev`          — forward NFT, nonlinear Schroedinger, vanishing BC
* :func:`nsep`          — forward NFT, NSE, (quasi-)periodic BC
* :func:`kdvv`          — forward NFT, Korteweg-de Vries, vanishing BC
* :func:`nsev_inverse`  — inverse NFT, NSE, vanishing BC

Design notes:
  - Everything is expressed as batched array programs: per-sample transfer
    matrices are built by a vectorized splitting combinator, multiplied in a
    log-depth FFT tree, and evaluated on spectral grids with chirp-Z
    transforms — no per-sample scalar loops.
  - Options are frozen dataclasses used as static (trace-time) arguments.
  - All kernels are dtype-polymorphic: complex128 (:func:`use_x64`) meets
    the reference's error bounds on the CPU and the GPU; complex64 is a
    separate, lower-accuracy contract.
  - Batches of signals vmap across examples and shard over device meshes
    (see :mod:`fnft_tpu.parallel`).
"""

from fnft_tpu.config import use_x64, default_complex_dtype
from fnft_tpu.models.discretization import Discretization
from fnft_tpu.models.nsev import (
    nsev,
    NsevOpts,
    NsevResult,
    BoundStateFilter,
    BoundStateLocalization,
    DiscspecType,
    ContspecType,
)
from fnft_tpu.models.kdvv import kdvv, KdvvOpts, KdvvResult
from fnft_tpu.models.nsep import (
    nsep,
    NsepOpts,
    NsepResult,
    PointFilter,
    Localization,
)
from fnft_tpu.models.nsev_inverse import (
    nsev_inverse,
    nsev_inverse_xi_grid,
    NsevInverseOpts,
    InverseContspecType,
    InverseCstMethod,
)


def nsev_fullspec_tpu(q128, t_span, *, m: int = 0, xi_span=None,
                      niter: int = 10):
    """Complete nsev (contspec + bound states + norming constants +
    residues) with every device op complex-free float32 (rc/df64 tiers,
    reference tolerance), for devices without complex types or float64.
    See :func:`fnft_tpu.ops.tpu_fullspec.nsev_fullspec_df64`. Raises
    :class:`fnft_tpu.errors.ComplexFreeTierUnavailableError` on a GPU
    backend, where :func:`nsev` in complex128 is the path.
    """
    from fnft_tpu.errors import require_complex_free_backend
    from fnft_tpu.ops.tpu_fullspec import nsev_fullspec_df64

    require_complex_free_backend("nsev_fullspec_tpu")

    return nsev_fullspec_df64(q128, t_span, m=m, xi_span=xi_span,
                              niter=niter)

__version__ = "0.1.0"
FNFT_REFERENCE_VERSION = (0, 4, 1, "")  # parity target: fnft_version.c:26-45


def fnft_version():
    """(major, minor, patch, suffix) — mirrors fnft_version (fnft_version.c:
    26-45) / mex_fnft_version; the suffix marks this rebuild."""
    major, minor, patch = (int(x) for x in __version__.split("."))
    return (major, minor, patch, "-tpu")

__all__ = [
    "nsev", "NsevOpts", "NsevResult", "fnft_version",
    "nsep", "NsepOpts", "NsepResult",
    "kdvv", "KdvvOpts", "KdvvResult",
    "nsev_inverse", "nsev_inverse_xi_grid", "NsevInverseOpts",
    "InverseContspecType", "InverseCstMethod",
    "Discretization", "BoundStateFilter", "BoundStateLocalization",
    "DiscspecType", "ContspecType", "PointFilter", "Localization",
    "use_x64", "default_complex_dtype", "nsev_fullspec_tpu",
]
