"""Forward NFT for the Korteweg-de Vries equation, vanishing BCs.

Rebuild of fnft_kdvv.c:59-209. KdV maps onto the AKNS system with
r = -1 (fnft__kdv_fscatter.c:75-76); the reflection coefficient is read off
the transfer matrix evaluated on the *negated* xi grid:

    rho(xi) = exp(2 i xi' (T1 + c eps)) H12(xi') / (2 i xi' H22(xi') - H12(xi'))

with xi' = -xi (tf2contspec_negxi, fnft_kdvv.c:126-209). The discrete
spectrum is explicitly "not yet implemented" in the reference
(fnft_kdvv.c:87-92); a bound-state extension is provided here through the
generic AKNS machinery in a later milestone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from fnft_tpu.config import complex_dtype_of
from fnft_tpu.errors import check_arg
from fnft_tpu.models.discretization import Discretization, degree, is_fast

from fnft_tpu.ops.poly import chirpz

BOUNDARY_COEFF = 0.5


@dataclasses.dataclass(frozen=True)
class KdvvOpts:
    """Defaults mirror fnft_kdvv_default_opts (fnft_kdvv.c:34-36).

    ``rsym``: assert that the potential is real-valued (the physical KdV
    case) even when it arrives as a complex-dtype device array or tracer,
    where elementwise inspection is impossible — the real-coefficient
    half-grid FFT tree is ~1.5x faster.  None = auto-detect from host
    arrays / real dtypes."""

    discretization: Discretization = Discretization.SPLIT8B
    rsym: Optional[bool] = None


@dataclasses.dataclass
class KdvvResult:
    reflection_coefficient: Optional[jnp.ndarray] = None
    bound_states: Optional[np.ndarray] = None  # zeta_n = i kappa_n


def kdvv_bound_states(u, t_span, *, opts: KdvvOpts | None = None,
                      tol_re: float = 1e-2):
    """Discrete KdV spectrum zeta_n = i kappa_n (eigenvalues E_n = -kappa_n^2).

    EXTENSION beyond the reference, which has this "not yet implemented"
    (src/fnft_kdvv.c:87-92): locate zeros of a(zeta) on the positive
    imaginary axis via the Aberth rootfinder on the transfer-matrix
    polynomial, like nsev's FAST_EIGENVALUE path.
    """
    from fnft_tpu.models.discretization import z_to_lambda
    from fnft_tpu.ops.roots import poly_roots
    from fnft_tpu.utils import misc

    opts = opts or KdvvOpts()
    disc = opts.discretization
    rsym = opts.rsym if opts.rsym is not None else _is_real_valued(u)
    u = jnp.asarray(u)
    cdt = complex_dtype_of(u)
    u = u.astype(cdt)
    d = u.shape[-1]
    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / (d - 1)
    tm, _ = kdv_fscatter(u, eps_t, disc, want=((0, 0),), rsym=rsym)
    roots_z = poly_roots(tm[0, 0])
    lam = np.asarray(z_to_lambda(roots_z, eps_t, disc))
    # keep near-imaginary-axis roots with positive imaginary part, inside
    # the resolvable band, then dedupe
    deg1 = degree(disc)
    im_max = 0.9 * np.pi / (2.0 / deg1 * eps_t)
    keep = (np.abs(lam.real) < tol_re) & (lam.imag > tol_re) \
        & (lam.imag < im_max)
    lam = 1j * np.unique(np.round(lam.imag[keep], 12))
    lam = misc.merge_points_host(lam, 1e-6)
    return lam


def _is_real_valued(u) -> bool:
    """True when ``u`` is demonstrably real-valued.

    Real-dtype arrays are decided from the dtype alone; complex host
    arrays are inspected elementwise.  Complex *device* arrays and
    tracers return False (inspection would force a device->host
    transfer / is impossible) — callers that cast to complex early
    should decide realness before the cast and pass ``rsym``
    explicitly."""
    dt = getattr(u, "dtype", None)
    if dt is not None:
        if not np.issubdtype(np.dtype(dt), np.complexfloating):
            return True
        if not isinstance(u, np.ndarray):
            return False
    try:
        a = np.asarray(u)
    except Exception:  # traced value: cannot decide, stay generic
        return False
    return not np.iscomplexobj(a) or not np.any(a.imag)


def kdv_fscatter(u, eps_t: float, disc: Discretization,
                 *, normalize: bool = True, want=None,
                 rsym: bool | None = None):
    """KdV polynomial scattering matrix: r = -1 then the AKNS kernel
    (reference fnft__kdv_fscatter.c:36-83).

    A real-valued potential (the physical KdV case) gives all-real
    transfer-matrix coefficients, so the FFT tree runs on
    conjugate-symmetric half grids (``rsym``); pass ``rsym`` explicitly
    when ``u`` is a complex-dtype array known to hold real values."""
    from fnft_tpu.ops.fscatter import fscatter as akns_fscatter

    if rsym is None:
        rsym = _is_real_valued(u)
    u = jnp.asarray(u)
    return akns_fscatter(u, -jnp.ones_like(u), eps_t, disc,
                         normalize=normalize, want=want, rsym=bool(rsym))


def kdv_scatter_matrix(q, lam, eps_t: float,
                       disc: Discretization = Discretization.BO,
                       *, derivative: bool = False):
    """Slow KdV scattering matrix (reference fnft__kdv_scatter_matrix.c:33-143).

    The AKNS r-potential is a per-stage constant: -1 for BO, the CF stage
    weights times -1 for the commutator-free schemes.
    """
    import numpy as np

    from fnft_tpu.models.discretization import lambda_stage_weights
    from fnft_tpu.ops.scatter import scatter_matrix

    q = jnp.asarray(q)
    d = q.shape[-1]
    stage_r = -np.asarray(lambda_stage_weights(disc))
    reps = d // len(stage_r)
    r = jnp.asarray(np.tile(stage_r, reps)).astype(complex_dtype_of(q))
    return scatter_matrix(q, r, lam, eps_t, disc, derivative=derivative)


def kdvv(u, t_span, *, m: int, xi_span, opts: KdvvOpts | None = None) -> KdvvResult:
    """Continuous KdV spectrum (reflection coefficient) on a xi grid."""
    opts = opts or KdvvOpts()
    disc = opts.discretization
    check_arg(is_fast(disc) and degree(disc) > 0,
              "kdvv requires a fast (2SPLIT) discretization")
    rsym = opts.rsym if opts.rsym is not None else _is_real_valued(u)
    u = jnp.asarray(u)
    cdt = complex_dtype_of(u)
    u = u.astype(cdt)
    d = u.shape[-1]
    t0, t1 = float(t_span[0]), float(t_span[1])
    xi0, xi1 = float(xi_span[0]), float(xi_span[1])
    check_arg(d >= 2 and t0 < t1 and xi0 < xi1 and m >= 2, "invalid grids")

    eps_t = (t1 - t0) / (d - 1)
    eps_xi = (xi1 - xi0) / (m - 1)
    deg1 = degree(disc)

    tm, _ = kdv_fscatter(u, eps_t, disc, want=((0, 1), (1, 1)), rsym=rsym)

    # evaluate H12, H22 at z(-xi_i), xi_i = xi0 + i eps_xi
    a_pt = complex(np.exp(-2j * xi0 * eps_t / deg1))
    w_pt = complex(np.exp(-2j * eps_xi * eps_t / deg1))
    h12 = chirpz(tm[0, 1], a_pt, w_pt, m)
    h22 = chirpz(tm[1, 1], a_pt, w_pt, m)

    rdt = jnp.real(u).dtype
    xi_neg = -(xi0 + eps_xi * jnp.arange(m, dtype=rdt))
    if disc is Discretization.SPLIT2A:
        # undo the first-order-polynomial trick (fnft_kdvv.c:186-195)
        sqrt_z = jnp.exp(1j * xi_neg * (eps_t / deg1))
        h12 = h12 / sqrt_z

    num = jnp.exp(2j * xi_neg * (t1 + BOUNDARY_COEFF * eps_t)) * h12
    den = 2j * xi_neg * h22 - h12
    return KdvvResult(reflection_coefficient=num / den)
