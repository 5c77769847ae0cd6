"""Unit-circle root search on a chirp-Z grid.

Rebuild of fnft__poly_roots_fftgridsearch.c. Both variants evaluate the
polynomial along arcs of (near-)unit circles with the chirp transform and
locate roots by purely local, embarrassingly parallel tests:

* :func:`roots_fftgridsearch` — minimum-modulus test on a 3x3 moving grid
  over three concentric rings, followed by a local linear least-squares
  root estimate (reference :35-154).
* :func:`roots_fftgridsearch_paraherm` — for polynomials where
  p(z) z^-(deg/2) is real on the circle: sign changes between consecutive
  grid points bracket roots (reference :162-219).

Shapes are static: the functions return ``(roots, mask)``; invalid slots are
masked out. ``phi`` bounds are static Python floats (grid geometry).
"""

from __future__ import annotations

import cmath
from functools import partial

import jax
import jax.numpy as jnp

from fnft_tpu.ops.poly import chirpz


@partial(jax.jit, static_argnames=("phi0", "phi1", "m"))
def roots_fftgridsearch(coeffs, *, phi0: float, phi1: float, m: int):
    """Roots near the unit-circle arc exp(i [phi0, phi1]).

    Returns (roots[m], mask[m]); masked-out entries are 0.
    """
    eps = (phi1 - phi0) / (m - 1)
    w = cmath.exp(1j * eps)
    vals = []
    for k in (-1, 0, 1):
        a = cmath.exp(1j * phi0) / (1.0 + k * eps)
        vals.append(chirpz(coeffs, a, w, m))
    vals = jnp.stack(vals)            # [3, m]: rings at radii 1/(1+k eps)
    mag = jnp.abs(vals)

    # 3x3 minimum-modulus test centered on the middle ring
    def shift(x, s):
        return jnp.roll(x, -s, axis=-1)

    center = mag[1]
    is_min = jnp.ones((m,), dtype=bool)
    for ring in range(3):
        for s in (-1, 0, 1):
            if ring == 1 and s == 0:
                continue
            is_min &= center <= shift(mag[ring], s)
    is_min = is_min.at[0].set(False).at[-1].set(False)

    # local linear LSQ fit p(z) ~ y0 + c (z - z0) over the 3x3 neighborhood
    rdt = jnp.real(vals).dtype
    angles = (phi0 + eps * jnp.arange(m, dtype=rdt))
    radii = jnp.asarray([1.0 / (1.0 - eps), 1.0, 1.0 / (1.0 + eps)], dtype=rdt)
    zgrid = radii[:, None] * jnp.exp(1j * angles)[None, :]
    z0 = jnp.exp(1j * angles)
    y0 = vals[1]

    num = jnp.zeros((m,), dtype=vals.dtype)
    den = jnp.zeros((m,), dtype=jnp.real(vals).dtype)
    for ring in range(3):
        for s in (-1, 0, 1):
            if ring == 1 and s == 0:
                continue
            zi = shift(zgrid[ring], s)
            yi = shift(vals[ring], s)
            num = num + jnp.conj(zi - z0) * (yi - y0)
            den = den + jnp.abs(zi - z0) ** 2
    c = num / jnp.where(den == 0, 1.0, den)
    c_zero = c == 0
    zr = jnp.where(c_zero, z0, z0 - y0 / jnp.where(c_zero, 1.0, c))
    ok_dist = jnp.where(c_zero, y0 == 0, jnp.abs(zr - z0) <= eps)
    mask = is_min & ok_dist
    return jnp.where(mask, zr, 0.0), mask


@partial(jax.jit, static_argnames=("phi0", "phi1", "m"))
def roots_fftgridsearch_paraherm(coeffs, *, phi0: float, phi1: float, m: int):
    """Unit-circle roots of a para-hermitian polynomial (even degree).

    After removing the phase factor z^{deg/2}, the values are real on the
    circle; sign changes between neighbors bracket roots, refined by linear
    interpolation. Returns (roots[m], mask[m]).
    """
    deg = coeffs.shape[-1] - 1
    eps = (phi1 - phi0) / (m - 1)
    w = cmath.exp(1j * eps)
    a = cmath.exp(1j * phi0)
    vals = chirpz(coeffs, a, w, m)
    rdt = jnp.real(vals).dtype
    angles = phi0 + eps * jnp.arange(m, dtype=rdt)
    vals = vals * jnp.exp(-1j * angles * (deg // 2))

    v = jnp.real(vals)
    v_prev = v[:-1]
    v_next = v[1:]
    sign_change = v_prev * v_next <= 0.0
    denom = v_next - v_prev
    frac = jnp.where(denom == 0, 0.5, -v_prev / jnp.where(denom == 0, 1.0, denom))
    phi_root = angles[:-1] + eps * frac
    roots = jnp.exp(1j * phi_root)
    mask = sign_change
    out = jnp.where(mask, roots, 0.0)
    # pad to m entries for a static shape
    out = jnp.concatenate([out, jnp.zeros((1,), out.dtype)])
    mask = jnp.concatenate([mask, jnp.zeros((1,), bool)])
    return out, mask
