"""Fast AKNS scattering: per-sample polynomial transfer matrices + FFT tree.

Rebuild of fnft__akns_fscatter.c. Instead of hard-coding the polynomial
coefficients of every splitting scheme (925 lines of formulas in the C
reference), the per-sample 2x2 polynomial matrix is *generated* by folding
the scheme's splitting specification (models.discretization.splitting_spec):
constant-matrix factors ``E(a)`` contract on the matrix axes, monomial
factors ``Z(a) = diag(1, z^a)`` shift coefficients. Everything is batched
over the D samples (and any leading batch axes) — pure array work with no
per-sample control flow.

The resulting stack feeds :func:`fnft_tpu.ops.poly.fmult2x2_tree`, giving
the O(D log^2 D) combined scattering matrix with 2^W normalization.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from fnft_tpu.config import complex_dtype_of
from fnft_tpu.models.discretization import (
    Discretization,
    degree,
    splitting_spec,
)
from fnft_tpu.ops.poly import fmult2x2_tree
from fnft_tpu.utils.misc import csinc, next_power_of_2


def _zero_freq_matrix(q, r, h):
    """E = expm([[0, q], [r, 0]] * h): closed form via cos / sinc.

    Reference: akns_fscatter_zero_freq_scatter_matrix (fnft__akns_fscatter.c:46-59).
    Returns [..., 2, 2].
    """
    delta = h * jnp.sqrt(-q * r)
    dsinc = h * csinc(delta)
    c = jnp.cos(delta)
    return jnp.stack([
        jnp.stack([c, q * dsinc], axis=-1),
        jnp.stack([r * dsinc, c], axis=-1),
    ], axis=-2)


def _shift_coeffs(p, a: int):
    """Multiply by z^a: shift along the (last) coefficient axis."""
    if a == 0:
        return p
    pad = jnp.zeros(p.shape[:-1] + (a,), dtype=p.dtype)
    return jnp.concatenate([pad, p[..., :-a]], axis=-1)


def transfer_matrix_coeffs(q, r, eps_t: float, disc: Discretization,
                           *, rsym: bool = False):
    """Per-sample polynomial transfer matrices ``[..., D, 2, 2, deg+1]``.

    ``q`` and ``r`` are the (preprocessed) AKNS potentials on the effective
    sample grid; ``eps_t`` is the step of the *original* grid (the splitting
    uses eps_t/deg internally, matching the reference's conventions).
    ``rsym`` asserts real-valued q and r (KdV), letting the generic path
    evaluate only the Hermitian half grid.
    """
    q = jnp.asarray(q)
    cdt = complex_dtype_of(q)
    q = q.astype(cdt)
    r = jnp.asarray(r).astype(cdt)
    deg = degree(disc)
    if deg == 0:
        raise ValueError(f"{disc} is not a fast (polynomial) discretization")

    if disc is Discretization.SPLIT2_MODAL:
        # Modified Ablowitz-Ladik: P = s [[1, eps q], [eps r, 1]] diag(1, z),
        # s = 1/sqrt(1 - eps^2 q r)   (fnft__akns_fscatter.c:118-147)
        scl = 1.0 / jnp.sqrt(1.0 - (eps_t * eps_t) * q * r)
        out = jnp.zeros(q.shape + (2, 2, 2), dtype=cdt)
        out = out.at[..., 0, 0, 0].set(scl)
        out = out.at[..., 0, 1, 1].set(scl * eps_t * q)
        out = out.at[..., 1, 0, 0].set(scl * eps_t * r)
        out = out.at[..., 1, 1, 1].set(scl)
        return out

    if disc is Discretization.SPLIT2A:
        # P = E(1) Z: one fused elementwise pass (hot default path)
        h = eps_t  # deg == 1
        delta = h * jnp.sqrt(-q * r)
        c = jnp.cos(delta)
        s = h * csinc(delta)
        out = jnp.zeros(q.shape + (2, 2, 2), dtype=cdt)
        out = out.at[..., 0, 0, 0].set(c)
        out = out.at[..., 0, 1, 1].set(q * s)
        out = out.at[..., 1, 0, 0].set(r * s)
        out = out.at[..., 1, 1, 1].set(c)
        return out

    if disc is Discretization.SPLIT4B:
        # Closed form of -1/3 E(1) Z^2 E(1) + 4/3 E(1/2) Z E(1) Z E(1/2)
        # (deg = 2, E(a) = expm([[0,q],[r,0]] a eps_t/2)). The product is
        # palindromic: P11 is the coefficient-reverse of P00 and
        # P01/q == P10/r, so only 5 distinct arrays are computed — one
        # fused elementwise pass instead of the generic combinator's
        # many intermediate [D, 2, 2, c] products.
        qr = q * r
        d1 = (eps_t / 2) * jnp.sqrt(-qr)
        c1 = jnp.cos(d1)
        s1 = (eps_t / 2) * csinc(d1)
        dh = d1 / 2
        ch = jnp.cos(dh)
        sh = (eps_t / 4) * csinc(dh)
        third = 1.0 / 3.0
        u0 = (4.0 * third) * ch * ch * c1 - third * c1 * c1
        u1 = (8.0 * third) * qr * ch * sh * s1
        u2 = (4.0 * third) * qr * sh * sh * c1 - third * qr * s1 * s1
        g0 = (4.0 * third) * ch * sh * c1 - third * c1 * s1
        g1 = (4.0 * third) * (qr * sh * sh * s1 + ch * ch * s1)
        out = jnp.zeros(q.shape + (2, 2, 3), dtype=cdt)
        out = out.at[..., 0, 0, 0].set(u0)
        out = out.at[..., 0, 0, 1].set(u1)
        out = out.at[..., 0, 0, 2].set(u2)
        out = out.at[..., 0, 1, 0].set(q * g0)
        out = out.at[..., 0, 1, 1].set(q * g1)
        out = out.at[..., 0, 1, 2].set(q * g0)
        out = out.at[..., 1, 0, 0].set(r * g0)
        out = out.at[..., 1, 0, 1].set(r * g1)
        out = out.at[..., 1, 0, 2].set(r * g0)
        out = out.at[..., 1, 1, 0].set(u2)
        out = out.at[..., 1, 1, 1].set(u1)
        out = out.at[..., 1, 1, 2].set(u0)
        return out

    if _value_coeffs_active():
        return _coeffs_via_values(q, r, eps_t, disc, real_coeffs=rsym)
    return _coeffs_symbolic(q, r, eps_t, disc)


_VALUE_COEFFS: bool | None = None  # None = auto (accelerators on, CPU off)


def set_value_coeffs(enabled: bool | None) -> None:
    """Force (True/False) or restore backend-auto (None) the value-space
    generic coefficient construction."""
    global _VALUE_COEFFS
    if enabled is not _VALUE_COEFFS:
        _VALUE_COEFFS = enabled
        jax.clear_caches()  # read at trace time


def _value_coeffs_active() -> bool:
    # On accelerators the uniform-shape elementwise chain + one small FFT
    # beats the symbolic fold's growing-shape concats and scatters; on
    # XLA:CPU the fold's early small-degree contractions are cheaper
    # (measured: SPLIT8B ~even, SPLIT7A 3.4x in the fold's favor).
    if _VALUE_COEFFS is not None:
        return _VALUE_COEFFS
    return jax.default_backend() != "cpu"


def _coeffs_via_values(q, r, eps_t: float, disc: Discretization,
                       *, real_coeffs: bool = False):
    """Generic splitting-spec transfer matrices, built in value space.

    Every term of the splitting specification is a product of constant
    matrices ``E(a)`` (shared across evaluation points) and monomial
    factors ``Z(a) = diag(1, z^a)`` (per-point scalar column scalings), so
    the per-sample degree-``deg`` polynomial matrix is cheapest to build by
    evaluating the whole chain at the n-th roots of unity
    (n = next pow2 >= deg+1) — a sequence of fused elementwise 2x2
    products with no coefficient shifts/concats — and recovering the exact
    coefficients with one small inverse FFT.  Replaces the symbolic
    convolution fold (kept as :func:`_coeffs_symbolic` for cross-checks);
    the reference instead hard-codes per-scheme coefficient formulas
    (fnft__akns_fscatter.c:64-925).

    With ``real_coeffs`` (KdV: real q and r = -1 make every coefficient
    real) only the Hermitian half grid k = 0..n/2 is evaluated and an
    irfft recovers the coefficients: ~half the chain work.
    """
    cdt = complex_dtype_of(q)
    deg = degree(disc)
    spec = splitting_spec(disc)
    n = next_power_of_2(deg + 1)
    npts = n // 2 + 1 if real_coeffs else n
    rdt = jnp.zeros((), cdt).real.dtype
    h = eps_t / deg
    delta = h * jnp.sqrt(-q * r)
    e_weights = sorted({a for _, fs in spec for kind, a in fs if kind == "E"})
    emat = {}
    for a in e_weights:
        da = a * delta
        c = jnp.cos(da)[..., None]
        s = (a * h) * csinc(da)
        emat[a] = (c, (q * s)[..., None], (r * s)[..., None])

    zpow_cache: dict[int, jnp.ndarray] = {}

    def _zp(ai: int):
        # z_k^ai with z_k = w_n^k, w_n = exp(-2i pi / n) (FFT grid order)
        if ai not in zpow_cache:
            ang = jnp.arange(npts, dtype=rdt) * (-2.0 * math.pi * ai / n)
            zpow_cache[ai] = jax.lax.complex(jnp.cos(ang), jnp.sin(ang))
        return zpow_cache[ai]

    tot = None
    for coeff, factors in spec:
        m = None       # running product (m00, m01, m10, m11), right-mult
        pend = 0       # z power accumulated before the first E factor
        for kind, a in factors:
            if kind == "Z":
                ai = int(round(a))
                if m is None:
                    pend += ai
                else:
                    zp = _zp(ai)
                    m = (m[0], m[1] * zp, m[2], m[3] * zp)
            else:
                c, qs, rs = emat[a]
                if m is None:
                    if pend:
                        zp = _zp(pend)
                        m = (c, qs, zp * rs, zp * c)
                        pend = 0
                    else:
                        m = (c, qs, rs, c)
                else:
                    m00, m01, m10, m11 = m
                    m = (m00 * c + m01 * rs, m00 * qs + m01 * c,
                         m10 * c + m11 * rs, m10 * qs + m11 * c)
        tgt = q.shape + (npts,)
        e00, e01, e10, e11 = (jnp.broadcast_to(x, tgt) for x in m)
        term = jnp.stack([jnp.stack([e00, e01], axis=-2),
                          jnp.stack([e10, e11], axis=-2)], axis=-3)
        tot = coeff * term if tot is None else tot + coeff * term

    if real_coeffs:
        out = jnp.fft.irfft(tot, n=n, axis=-1)[..., : deg + 1]
        return out.astype(cdt)
    return jnp.fft.ifft(tot, axis=-1)[..., : deg + 1]


def _coeffs_symbolic(q, r, eps_t: float, disc: Discretization):
    """Symbolic (coefficient-space) splitting-spec fold.

    The original generic construction — E factors contract on the matrix
    axes, Z factors shift coefficients — kept as the cross-check oracle
    for :func:`_coeffs_via_values` (tests/test_fscatter.py)."""
    q = jnp.asarray(q)
    cdt = complex_dtype_of(q)
    q = q.astype(cdt)
    r = jnp.asarray(r).astype(cdt)
    deg = degree(disc)
    spec = splitting_spec(disc)
    # distinct E weights used by the scheme
    e_weights = sorted({a for _, fs in spec for kind, a in fs if kind == "E"})
    e_mats = {a: _zero_freq_matrix(q, r, a * eps_t / deg) for a in e_weights}

    total = jnp.zeros(q.shape + (2, 2, deg + 1), dtype=cdt)
    for coeff, factors in spec:
        p = None  # running product, [..., 2, 2, c]
        for kind, a in factors:
            if kind == "E":
                e = e_mats[a]
                if p is None:
                    p = e[..., None]
                else:
                    p = jnp.einsum("...ikc,...kj->...ijc", p, e)
            else:  # Z(a): right-multiplication scales column 2 by z^a
                ai = int(round(a))
                if p is None:
                    p = jnp.zeros(q.shape + (2, 2, ai + 1), dtype=cdt)
                    p = p.at[..., 0, 0, 0].set(1.0).at[..., 1, 1, ai].set(1.0)
                else:
                    p = jnp.concatenate(
                        [p, jnp.zeros(p.shape[:-1] + (ai,), dtype=cdt)], axis=-1)
                    col2 = _shift_coeffs(p[..., :, 1, :], ai)
                    p = jnp.stack([p[..., :, 0, :], col2], axis=-2)
        if p.shape[-1] < deg + 1:
            p = jnp.concatenate(
                [p, jnp.zeros(p.shape[:-1] + (deg + 1 - p.shape[-1],), cdt)],
                axis=-1)
        total = total + jnp.asarray(coeff, dtype=cdt) * p[..., : deg + 1]
    return total


@partial(jax.jit,
         static_argnames=("eps_t", "disc", "normalize", "want", "jsym",
                          "rsym"))
def fscatter(q, r, eps_t: float, disc: Discretization, *, normalize: bool = True,
             want=None, jsym: int | None = None, rsym: bool = False):
    """Combined polynomial scattering matrix of D samples.

    Returns (transfer_matrix ``[..., 2, 2, D*deg+1]``, w) with
    ``true = stored * 2**w``. Equivalent to fnft__akns_fscatter.c:64-925
    followed by poly_fmult2x2.  ``want`` optionally names the (row, col)
    entries the caller reads; the rest come back zero (saves final-size
    inverse FFTs in the tree).  ``jsym``: see
    :func:`fnft_tpu.ops.poly.fmult2x2_tree` — pass the kappa sign when
    ``r == -kappa * conj(q)`` to halve the tree's FFT work.  ``rsym``:
    pass True when ``q`` and ``r`` are both real-valued (KdV) so the
    tree carries conjugate-symmetric half grids.
    """
    p = transfer_matrix_coeffs(q, r, eps_t, disc, rsym=rsym)
    return fmult2x2_tree(p, normalize=normalize, want=want, jsym=jsym,
                         rsym=rsym)
