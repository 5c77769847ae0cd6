"""Error model.

The reference uses errno-style integer codes with goto-cleanup
(fnft__errwarn.h:36-114). In a JAX-native library the natural split is:

* static / shape / argument errors -> raise Python exceptions on the host
  (before tracing),
* data-dependent numerical failures inside jitted code -> NaN propagation,
  surfaced by the drivers.

Warnings go through the ``warnings`` module (the analogue of the reference's
pluggable printf, fnft_errwarn.c:42-60).
"""

from __future__ import annotations

import threading
import warnings


class FnftError(Exception):
    """Base class for fnft-tpu errors."""


class InvalidArgumentError(FnftError, ValueError):
    """Mirrors FNFT_EC_INVALID_ARGUMENT."""


class NotYetImplementedError(FnftError, NotImplementedError):
    """Mirrors FNFT_EC_NOT_YET_IMPLEMENTED."""


class ComplexFreeTierUnavailableError(FnftError, RuntimeError):
    """The float32-pair (rc/df64) tier was called on a GPU backend.

    The tier stands in for complex128 on devices without complex types or
    float64. On a GPU the complex128 drivers (:func:`fnft_tpu.nsev` and
    the others) are the path; the tier's programs did not finish compiling
    within 300 s on an H100 and its accuracy there is unverified, so it
    refuses rather than risk a silent wrong answer (ROADMAP D2)."""


def require_complex_free_backend(entry: str) -> None:
    """Raise :class:`ComplexFreeTierUnavailableError` on a GPU backend."""
    import jax

    if jax.default_backend() == "gpu":
        raise ComplexFreeTierUnavailableError(
            f"{entry} is part of the float32-pair tier, which is not "
            "supported on GPU backends; use the complex128 drivers "
            "(fnft_tpu.nsev, nsep, kdvv, nsev_inverse) with "
            "fnft_tpu.use_x64() instead")


def check_arg(cond: bool, message: str) -> None:
    if not cond:
        raise InvalidArgumentError(message)


_warn_handler = None
_tls = threading.local()


def set_warn_handler(handler, *, thread_local: bool = False) -> None:
    """Install a custom warning sink, or None to restore the default.

    Mirrors the reference's pluggable printf (fnft_errwarn_setprintf,
    src/fnft_errwarn.c:52-60). The reference's function pointer is
    thread-local (fnft_errwarn.c:42-50); pass ``thread_local=True`` for the
    same isolation (the embedded C API used from threaded hosts installs
    per-thread sinks this way). The process-global sink remains the
    fallback for threads without one.
    """
    if thread_local:
        _tls.handler = handler
        return
    global _warn_handler
    _warn_handler = handler


def get_warn_handler():
    """Active sink for the calling thread (thread-local wins, then global)."""
    h = getattr(_tls, "handler", None)
    return h if h is not None else _warn_handler


def warn(message: str) -> None:
    """Soft condition reporting (reference: FNFT__WARN)."""
    handler = get_warn_handler()
    if handler is not None:
        handler(message)
        return
    warnings.warn(message, RuntimeWarning, stacklevel=2)
