"""Real-lowered NSE contspec pipeline for complex-free backends.

This is the flagship benchmark pipeline (__graft_entry__._rho_pipeline:
SPLIT4B transfer matrices -> J-symmetric value tree -> chirp-Z -> rho),
re-expressed entirely in real-pair arithmetic (:mod:`fnft_tpu.ops.rc`)
with all transforms as DFT matmuls (:mod:`fnft_tpu.ops.mxu_fft`).
It was written for an accelerator without complex types: the complex
pipeline cannot run there, while this one is pure real f32 — matmuls,
elementwise, reshapes. It is part of the complex-free tier (ROADMAP D2).

Structure mirrors ops/poly.py's J-symmetric value tree exactly (see the
invariants documented there: P22 = rev(conj(P11)), P12 = -kappa
rev(conj(P21)), closed under products).  Three lowering-specific choices:

* With r = -kappa conj(q), every SPLIT4B closed-form coefficient
  u0..u2, g0, g1 is REAL (ops/fscatter.py:99-132): the per-sample column
  build is almost entirely real arithmetic.
* Direct-convolution early levels stay column-only using the coefficient-
  space involution rev(conj(.)) (index reversal + imag negation).
* The 2^w rescaling exponents cancel in rho = h21/h11, so the tree skips
  the exponent side channel and only rescales magnitudes.

Numerical contract: c64-equivalent (f32 pairs); matches the complex
pipeline on CPU to ~1e-6 relative and is validated against the
Satsuma-Yajima closed form (|rho(0)| = 0.7265425 for A=3.2).

Reference for the math being computed: fnft_nsev.c continuous-spectrum
path (tf2contspec) with 2SPLIT4B; this file only re-targets the hardware.
"""

from __future__ import annotations

import math
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from fnft_tpu.ops import rc, tables
from fnft_tpu.ops.mxu_fft import fft_pair, ifft_pair
from fnft_tpu.utils.misc import next_power_of_2

_CONV_CUTOFF = 16  # same crossover as ops/poly.py


# ---------------------------------------------------------------------------
# SPLIT4B per-sample transfer-matrix column (real-pair form)
# ---------------------------------------------------------------------------

def _csinc_real(x):
    """sin(x)/x with the x -> 0 limit, for real x (utils.misc.csinc)."""
    safe = jnp.where(jnp.abs(x) < 1e-20, 1.0, x)
    return jnp.where(jnp.abs(x) < 1e-20, 1.0, jnp.sin(safe) / safe)


def _split4b_column(q: rc.Pair, eps_t: float, kappa: int):
    """Column (P11, P21) coefficients for 2SPLIT4B with r = -kappa conj(q).

    Returns (col_re, col_im) of shape [..., 2, 3] (row axis, coeff axis).
    qr = q r = -kappa |q|^2 is real, so u*/g* are real
    (ops/fscatter.py:99-132); only P21 = r * g is complex.
    """
    qre, qim = q
    aq2 = qre * qre + qim * qim            # |q|^2
    qr = -float(kappa) * aq2               # q*r, real
    # sqrt(-qr) = sqrt(kappa |q|^2): real for focusing (kappa=+1).
    # For defocusing, -qr = -|q|^2 < 0 -> delta imaginary; cos(ix)=cosh(x).
    if kappa == 1:
        d1 = (eps_t / 2) * jnp.sqrt(aq2)
        c1 = jnp.cos(d1)
        s1 = (eps_t / 2) * _csinc_real(d1)
        dh = d1 / 2
        ch = jnp.cos(dh)
        sh = (eps_t / 4) * _csinc_real(dh)
    else:
        x1 = (eps_t / 2) * jnp.sqrt(aq2)
        c1 = jnp.cosh(x1)
        s1 = (eps_t / 2) * jnp.where(x1 < 1e-20, 1.0,
                                     jnp.sinh(x1) / jnp.where(x1 == 0, 1.0, x1))
        xh = x1 / 2
        ch = jnp.cosh(xh)
        sh = (eps_t / 4) * jnp.where(xh < 1e-20, 1.0,
                                     jnp.sinh(xh) / jnp.where(xh == 0, 1.0, xh))
    third = 1.0 / 3.0
    u0 = (4.0 * third) * ch * ch * c1 - third * c1 * c1
    u1 = (8.0 * third) * qr * ch * sh * s1
    u2 = (4.0 * third) * qr * sh * sh * c1 - third * qr * s1 * s1
    g0 = (4.0 * third) * ch * sh * c1 - third * c1 * s1
    g1 = (4.0 * third) * (qr * sh * sh * s1 + ch * ch * s1)
    # P11 = [u0, u1, u2] (real);  P21 = r [g0, g1, g0], r = -kappa conj(q)
    p11_re = jnp.stack([u0, u1, u2], axis=-1)
    zeros = jnp.zeros_like(p11_re)
    rk = -float(kappa)
    p21_re = jnp.stack([rk * qre * g0, rk * qre * g1, rk * qre * g0], axis=-1)
    p21_im = jnp.stack([-rk * qim * g0, -rk * qim * g1, -rk * qim * g0],
                       axis=-1)
    col_re = jnp.stack([p11_re, p21_re], axis=-2)
    col_im = jnp.stack([zeros, p21_im], axis=-2)
    return col_re, col_im


# ---------------------------------------------------------------------------
# J-symmetric tree levels (real-pair form of ops/poly.py)
# ---------------------------------------------------------------------------

def _rev(p: rc.Pair) -> rc.Pair:
    """Coefficient reversal (z^deg p(1/z) for a full-length array)."""
    return p[0][..., ::-1], p[1][..., ::-1]


def _polymul_direct(a: rc.Pair, b: rc.Pair) -> rc.Pair:
    """[..., c] x [..., c] coefficient convolution -> [..., 2c-1]."""
    c = a[0].shape[-1]
    out_re = jnp.zeros(a[0].shape[:-1] + (2 * c - 1,), a[0].dtype)
    out_im = jnp.zeros_like(out_re)
    for s in range(c):
        br, bi = b[0][..., s:s + 1], b[1][..., s:s + 1]
        pr, pi = rc.mul((br, bi), a)
        out_re = out_re.at[..., s:s + c].add(pr)
        out_im = out_im.at[..., s:s + c].add(pi)
    return out_re, out_im


def _conv_level_sym(col: rc.Pair, kappa: int, do_norm: bool) -> rc.Pair:
    """One direct-convolution level on column stacks [..., n, 2, c].

    C11 = B11 A11 - kappa rev(conj(B21)) A21
    C21 = B21 A11 +       rev(conj(B11)) A21
    """
    re, im = col
    a = (re[..., 0::2, :, :], im[..., 0::2, :, :])
    b = (re[..., 1::2, :, :], im[..., 1::2, :, :])
    a11 = (a[0][..., 0, :], a[1][..., 0, :])
    a21 = (a[0][..., 1, :], a[1][..., 1, :])
    b11 = (b[0][..., 0, :], b[1][..., 0, :])
    b21 = (b[0][..., 1, :], b[1][..., 1, :])
    b12 = rc.rmul(_rev(rc.conj(b21)), -float(kappa))
    b22 = _rev(rc.conj(b11))
    c11 = rc.add(_polymul_direct(a11, b11), _polymul_direct(a21, b12))
    c21 = rc.add(_polymul_direct(a11, b21), _polymul_direct(a21, b22))
    out = rc.stack([c11, c21], axis=-2)
    if do_norm:
        out = _rescale(out, axes=(-3, -2, -1))
    return out


def _rescale(p: rc.Pair, axes) -> rc.Pair:
    """Power-of-two magnitude rescale (the 2^w exponent cancels in rho)."""
    m = jnp.maximum(jnp.max(jnp.abs(p[0]), axis=axes),
                    jnp.max(jnp.abs(p[1]), axis=axes))
    safe = jnp.where(m > 0, m, 1.0)
    a_exp = jnp.where(m > 0, jnp.floor(jnp.log2(safe)), 0.0).astype(jnp.int32)
    scale = jnp.ldexp(jnp.asarray(1.0, p[0].dtype), -a_exp)
    nd = p[0].ndim - len(axes)
    scale = scale.reshape(scale.shape + (1,) * len(axes))
    return p[0] * scale, p[1] * scale


@lru_cache(maxsize=None)
def _half_twiddle_np(n: int) -> tuple[np.ndarray, np.ndarray]:
    """exp(-i pi j / n), j = 0..n-1, exact-phase f32 host table."""
    ang = (math.pi / n) * np.arange(n, dtype=np.float64)
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def _value_odd_bins_rc(V: rc.Pair, t: rc.Pair, tw: rc.Pair) -> rc.Pair:
    """ops/poly._value_odd_bins in real pairs (one IFFT + one twisted FFT)."""
    q = ifft_pair(V)
    o = fft_pair(rc.mul(q, tw))
    return o[0] - 2.0 * t[0][..., None], o[1] - 2.0 * t[1][..., None]


def _interleave(even: rc.Pair, odd: rc.Pair) -> rc.Pair:
    n = even[0].shape[-1]
    re = jnp.stack([even[0], odd[0]], axis=-1).reshape(
        even[0].shape[:-1] + (2 * n,))
    im = jnp.stack([even[1], odd[1]], axis=-1).reshape(
        even[1].shape[:-1] + (2 * n,))
    return re, im


def _value_level_sym_rc(Vc: rc.Pair, tc: rc.Pair, cc: rc.Pair, kappa: int,
                        do_norm: bool):
    """ops/poly._value_level_sym lowered to real pairs.

    Vc: [..., n, 2, N] column values; tc/cc: [..., n, 2] top/zeroth coeffs.
    """
    def _sel(p, sl, axis_from_end):
        idx = (Ellipsis, sl) + (slice(None),) * axis_from_end
        return p[0][idx], p[1][idx]

    Va, Vb = _sel(Vc, slice(0, None, 2), 2), _sel(Vc, slice(1, None, 2), 2)
    ta, tb = _sel(tc, slice(0, None, 2), 1), _sel(tc, slice(1, None, 2), 1)
    ca, cb = _sel(cc, slice(0, None, 2), 1), _sel(cc, slice(1, None, 2), 1)
    n = Va[0].shape[-1]
    tw = tables.get(("half_twiddle", n), lambda: _half_twiddle_np(n))

    def _row(p, i):
        return p[0][..., i, :], p[1][..., i, :]

    a11, a21 = _row(Va, 0), _row(Va, 1)
    b11, b21 = _row(Vb, 0), _row(Vb, 1)
    k = float(kappa)
    # even bins (z^N == 1): B12 = -kappa conj(B21), B22 = conj(B11)
    even11 = rc.sub(rc.mul(b11, a11), rc.rmul(rc.mul(rc.conj(b21), a21), k))
    even21 = rc.add(rc.mul(b21, a11), rc.mul(rc.conj(b11), a21))
    # odd bins (z^N == -1): signs flip
    Bo = _value_odd_bins_rc(Vb, tb, (tw[0][None, :], tw[1][None, :]))
    Ao = _value_odd_bins_rc(Va, ta, (tw[0][None, :], tw[1][None, :]))
    a11o, a21o = _row(Ao, 0), _row(Ao, 1)
    b11o, b21o = _row(Bo, 0), _row(Bo, 1)
    odd11 = rc.add(rc.mul(b11o, a11o),
                   rc.rmul(rc.mul(rc.conj(b21o), a21o), k))
    odd21 = rc.sub(rc.mul(b21o, a11o), rc.mul(rc.conj(b11o), a21o))
    V11 = _interleave(even11, odd11)
    V21 = _interleave(even21, odd21)
    V_out = rc.stack([V11, V21], axis=-2)

    def _e(p, i):
        return p[0][..., i], p[1][..., i]

    t11 = rc.sub(rc.mul(_e(tb, 0), _e(ta, 0)),
                 rc.rmul(rc.mul(rc.conj(_e(cb, 1)), _e(ta, 1)), k))
    t21 = rc.add(rc.mul(_e(tb, 1), _e(ta, 0)),
                 rc.mul(rc.conj(_e(cb, 0)), _e(ta, 1)))
    c11 = rc.sub(rc.mul(_e(cb, 0), _e(ca, 0)),
                 rc.rmul(rc.mul(rc.conj(_e(tb, 1)), _e(ca, 1)), k))
    c21 = rc.add(rc.mul(_e(cb, 1), _e(ca, 0)),
                 rc.mul(rc.conj(_e(tb, 0)), _e(ca, 1)))
    t_out = rc.stack([t11, t21], axis=-1)
    c_out = rc.stack([c11, c21], axis=-1)
    if do_norm:
        m = jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(V_out[0]), axis=(-2, -1)),
                        jnp.max(jnp.abs(V_out[1]), axis=(-2, -1))),
            jnp.maximum(
                jnp.maximum(jnp.max(jnp.abs(t_out[0]), axis=-1),
                            jnp.max(jnp.abs(t_out[1]), axis=-1)),
                jnp.maximum(jnp.max(jnp.abs(c_out[0]), axis=-1),
                            jnp.max(jnp.abs(c_out[1]), axis=-1))))
        safe = jnp.where(m > 0, m, 1.0)
        a_exp = jnp.where(m > 0, jnp.floor(jnp.log2(safe)), 0.0)
        scale = jnp.ldexp(jnp.asarray(1.0, V_out[0].dtype),
                          -a_exp.astype(jnp.int32))
        V_out = (V_out[0] * scale[..., None, None],
                 V_out[1] * scale[..., None, None])
        t_out = (t_out[0] * scale[..., None], t_out[1] * scale[..., None])
        c_out = (c_out[0] * scale[..., None], c_out[1] * scale[..., None])
    return V_out, t_out, c_out


def _tree_column_rc(col: rc.Pair, kappa: int):
    """Full J-symmetric tree on column stacks [..., n, 2, 3].

    Returns the final column coefficients as rc pair [..., 2, 2n_deg+1]
    (rows: P11, P21), up to a positive power-of-two overall scale.
    """
    n = col[0].shape[-3]
    assert n & (n - 1) == 0, "real-pair pipeline requires power-of-two D"
    levels = int(math.log2(n)) if n > 1 else 0

    def _do_norm(lv):
        return lv % 2 == 1 or lv == levels - 1

    lv = 0
    while lv < levels and col[0].shape[-1] <= _CONV_CUTOFF:
        col = _conv_level_sym(col, kappa, _do_norm(lv))
        lv += 1
    if lv == levels:
        # squeeze the node axis only: [..., 1, 2, c] -> [..., 2, c]
        return col[0].squeeze(-3), col[1].squeeze(-3)
    # enter value space: grid N = n_coef - 1 (power of two by construction)
    n_coef = col[0].shape[-1]
    tc = (col[0][..., n_coef - 1], col[1][..., n_coef - 1])
    cc = (col[0][..., 0], col[1][..., 0])
    Vc = fft_pair((col[0][..., : n_coef - 1], col[1][..., : n_coef - 1]))
    Vc = (Vc[0] + tc[0][..., None], Vc[1] + tc[1][..., None])
    while lv < levels:
        Vc, tc, cc = _value_level_sym_rc(Vc, tc, cc, kappa, _do_norm(lv))
        lv += 1
    # exit: coefficients of the two rows
    qs = ifft_pair(Vc)
    qs = (qs[0].at[..., 0].add(-tc[0]), qs[1].at[..., 0].add(-tc[1]))
    out = rc.concatenate([qs, (tc[0][..., None], tc[1][..., None])], axis=-1)
    # squeeze the node axis only: [..., 1, 2, N+1] -> [..., 2, N+1]
    return out[0].squeeze(-3), out[1].squeeze(-3)


# ---------------------------------------------------------------------------
# Chirp-Z in real pairs (static spiral tables, matmul FFTs)
# ---------------------------------------------------------------------------

def _spiral_np(base: complex, exponents: np.ndarray) -> np.ndarray:
    """base**exponents at extended precision (ops/poly._spiral_table)."""
    theta = np.longdouble(math.atan2(base.imag, base.real))
    e = exponents.astype(np.longdouble)
    phase = np.mod(e * theta, np.longdouble(2 * math.pi))
    log_mag = np.log(np.abs(base)) if abs(base) != 1.0 else 0.0
    mag = np.exp(e * np.longdouble(log_mag)) if log_mag != 0.0 else 1.0
    return (mag * (np.cos(phase.astype(np.float64))
                   + 1j * np.sin(phase.astype(np.float64))))


def chirpz_rc(coeffs: rc.Pair, a: complex, w: complex, m: int) -> rc.Pair:
    """p(a w^k), k = 0..m-1, via Bluestein convolution with matmul FFTs.

    Mirrors ops/poly.chirpz but forces a power-of-two convolution length
    (mxu_fft factorizes powers of two only)."""
    n = coeffs[0].shape[-1]
    length = next_power_of_2(n + m - 1)
    a, w = complex(a), complex(w)

    def _pair(z):
        return (z.real.astype(np.float32), z.imag.astype(np.float32))

    def _xw():
        ks = np.arange(n, dtype=np.float64)
        return _pair(_spiral_np(a, ks) * _spiral_np(w, 0.5 * ks * ks))

    def _vf():
        ks = np.arange(max(n, m), dtype=np.float64)
        w_half_sq = _spiral_np(w, 0.5 * ks * ks)
        v = np.zeros(length, dtype=np.complex128)
        v[:m] = 1.0 / w_half_sq[:m]
        neg = _spiral_np(w, 0.5 * ks[1:n] * ks[1:n])
        v[length - n + 1:] = (1.0 / neg)[::-1]
        return _pair(np.fft.fft(v))

    def _wout():
        ks = np.arange(m, dtype=np.float64)
        return _pair(_spiral_np(w, 0.5 * ks * ks))

    key = (n, m, a, w)
    x_w = tables.get(("chirpz_xw",) + key, _xw)
    v_f = tables.get(("chirpz_vf",) + key, _vf)
    w_out = tables.get(("chirpz_wout",) + key, _wout)
    x = rc.mul(coeffs, x_w)
    xp = rc.apply(lambda t: jnp.pad(t, [(0, 0)] * (t.ndim - 1)
                                    + [(0, length - n)]), x)
    conv = ifft_pair(rc.mul(fft_pair(xp), v_f))
    head = (conv[0][..., :m], conv[1][..., :m])
    return rc.mul(head, w_out)


# ---------------------------------------------------------------------------
# Full contspec pipeline
# ---------------------------------------------------------------------------

def rho_pipeline_rc(d: int, m: int, t_span, xi_span, *, kappa: int = 1):
    """Jittable (q_re, q_im) [..., D] -> (rho_re, rho_im) [..., M].

    Real-lowered twin of __graft_entry__._rho_pipeline (2SPLIT4B).  The
    2^w tree rescaling cancels in h21/h11, and the phase factor matches
    models/nse.phase_factor_rho for SPLIT4B.
    """
    from fnft_tpu.models import nse
    from fnft_tpu.models.discretization import Discretization

    t0, t1 = t_span
    xi0, xi1 = xi_span
    eps_t = (t1 - t0) / (d - 1)
    deg1 = 2.0  # degree * upsampling for 2SPLIT4B
    eps_xi = (xi1 - xi0) / (m - 1)
    a_pt = complex(np.exp(2j * xi0 * eps_t / deg1))
    w_pt = complex(np.exp(2j * eps_xi * eps_t / deg1))
    pf_rho = float(nse.phase_factor_rho(eps_t, t1, Discretization.SPLIT4B))

    def rho(q_re, q_im):
        col = _split4b_column((q_re, q_im), eps_t, kappa)
        rows = _tree_column_rc(col, kappa)
        # rows: [..., 2, deg_total+1]; chirp-Z both rows in one batch
        h = chirpz_rc((rows[0], rows[1]), a_pt, w_pt, m)
        h11 = (h[0][..., 0, :], h[1][..., 0, :])
        h21 = (h[0][..., 1, :], h[1][..., 1, :])
        xi = jnp.linspace(np.float32(xi0), np.float32(xi1), m,
                          dtype=q_re.dtype)
        phase = rc.cis(xi * np.float32(pf_rho))
        out = rc.mul(rc.div(h21, h11), phase)
        return out

    return rho


def rho_pipeline_tabled(d: int, m: int, t_span, xi_span, *, kappa: int = 1,
                        batch: int | None = None):
    """Jitted pipeline with all tables passed as device parameters.

    Use this (not ``jax.jit(rho_pipeline_rc(...))``) for large D: inlining
    the DFT/twiddle/chirp-Z tables as literals produces a >200 MB StableHLO
    payload at D=2^20 (see :mod:`fnft_tpu.ops.tables`).
    """
    from fnft_tpu.errors import require_complex_free_backend

    require_complex_free_backend("rho_pipeline_tabled")
    fn = rho_pipeline_rc(d, m, t_span, xi_span, kappa=kappa)
    shape = (d,) if batch is None else (batch, d)
    ex = (jax.ShapeDtypeStruct(shape, jnp.float32),) * 2
    return tables.jit_tabled(fn, ex)
