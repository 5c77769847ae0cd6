"""Public surface of the double-float (float32-pair) mode.

Convenience namespace re-exporting the float32-pair pipelines:

>>> from fnft_tpu import df64
>>> rho = df64.nsev_contspec(q, d=4096, m=4096, t_span=..., xi_span=...)
>>> lam = df64.nsev_boundstates(q, d=4096, t_span=...)
>>> rho_kdv = df64.kdvv_contspec(u, d=4096, m=16, t_span=..., xi_span=...)
>>> q = df64.finvscatter(transfer_matrix, eps_t, kappa)
>>> q = df64.nsev_inverse(rho, xi_span, d, t_span, kappa=-1)

See docs/performance.md ("Precision") for the tier's accuracy. On a GPU
backend every entry point raises
:class:`fnft_tpu.errors.ComplexFreeTierUnavailableError`: use the
complex128 drivers there.
"""

import functools

from fnft_tpu.errors import require_complex_free_backend
from fnft_tpu.ops import df64 as _df64
from fnft_tpu.ops import df64_inverse as _inv
from fnft_tpu.ops import df64_pipeline as _pipe


def _not_on_gpu(fn):
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        require_complex_free_backend(f"fnft_tpu.df64.{fn.__name__}")
        return fn(*args, **kwargs)
    return entry


poly_specfact = _not_on_gpu(_df64.poly_specfact_df64)
finvscatter = _not_on_gpu(_inv.finvscatter_df64)
nsev_inverse_b_of_tau = _not_on_gpu(_inv.nsev_inverse_b_of_tau_df64)
nsev_inverse_b_of_xi = _not_on_gpu(_inv.nsev_inverse_b_of_xi_df64)
nsev_inverse = _not_on_gpu(_inv.nsev_inverse_df64)
kdvv_contspec = _not_on_gpu(_pipe.kdvv_contspec_df64)
nsev_boundstates = _not_on_gpu(_pipe.nsev_boundstates_df64)
nsev_boundstates_batched = _not_on_gpu(_pipe.nsev_boundstates_df64_batched)
nsev_contspec = _not_on_gpu(_pipe.nsev_contspec_df64)
