"""Reference-accuracy bound-state sweeps in float32-pair (df64) arithmetic.

The discrete-spectrum half of the flagship nsev driver — Newton refinement
on a(lam) and the phi/psi sweeps for (a, a', b) at the bound states
(reference fnft__nse_scatter_bound_states.c:29-668, fnft_nsev.c:595-741,
895-970) — lowered to a complex-free float32 backend at reference (c128)
tolerance:

* every complex value is a cdf pytree (four float32 hi/lo planes,
  fnft_tpu.ops.df64);
* the BO one-step matrix needs NO transcendentals: its entries
  ch = cosh(k h) and sh = sinh(k h)/k are EVEN functions of
  k = sqrt(qr - lam^2), so they are short Horner series in
  w = (qr - lam^2) h^2 — |w| <= ~1 for any resolvable step, where 12
  terms reach 1e-16 (same device-friendly trick as the df64 contspec
  transfer matrices, ops/df64_pipeline._zero_freq_matrix_df64). The
  lambda-derivative factor g = (h ch - sh)/k^2 is the series
  h^3 sum_n w^n (1/(2n+2)! - 1/(2n+3)!) — no 0/0 limit to guard;
* float32's e+-38 range cannot hold exp(+-Im(lam) * T) at soliton
  eigenvalues, so products are renormalized per chunk by an exact power
  of two with an int32 exponent side channel; Newton and the b error
  metric use exponent-free ratios, and the few final (a', b) values are
  recombined on the host in float64.

Memory follows ops/scatter._bound_states_chunked: per-chunk tree
products + a scan over chunks, O(D/L + L) live values instead of the
[D, K, 2, 2] trajectory.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from fnft_tpu.ops.df64 import (
    cdf_add,
    cdf_from_c128,
    cdf_mul,
    cdf_sub,
    cdf_to_c128,
    df_add,
    df_log,
    df_mul,
    df_sub,
)

_SERIES_TERMS = 12
_DF64_TOL = 100.0 * (2.0 ** -49)


# ---------------------------------------------------------------------------
# small cdf helpers (values are ((re_hi, re_lo), (im_hi, im_lo)) pytrees)
# ---------------------------------------------------------------------------

def _cdf_map(f, *zs):
    return jax.tree.map(f, *zs)


def _cdf_scale_pow2(z, scale):
    """Multiply by an exact power-of-two f32 array (error-free)."""
    return jax.tree.map(lambda t: t * scale, z)


def _cdf_muli(z):
    """i * z."""
    re, im = z
    return ((-im[0], -im[1]), re)


def _cdf_neg(z):
    return jax.tree.map(lambda t: -t, z)


def _cdf_scale_host(z, s: float):
    """Multiply by a host float64 scalar (split into df64)."""
    sh = np.float32(s)
    sl = np.float32(np.float64(s) - np.float64(sh))

    def dfm(x):
        return df_mul(x, (jnp.broadcast_to(jnp.float32(sh), x[0].shape),
                          jnp.broadcast_to(jnp.float32(sl), x[0].shape)))

    return (dfm(z[0]), dfm(z[1]))


def _cdf_div_guarded(x, y):
    """cdf x / y with a y == 0 guard (returns 0 there)."""
    from fnft_tpu.ops.df64 import cdf_div

    bad = (y[0][0] == 0) & (y[1][0] == 0)
    safe = ((jnp.where(bad, 1.0, y[0][0]), jnp.where(bad, 0.0, y[0][1])),
            (jnp.where(bad, 0.0, y[1][0]), jnp.where(bad, 0.0, y[1][1])))
    q = cdf_div(x, safe)
    return jax.tree.map(lambda t: jnp.where(bad, 0.0, t), q)


def _df_series_horner(w, coeffs_f64):
    """sum_k c_k w^k for cdf w and host float64 coefficients."""
    acc = None
    for ck in reversed(coeffs_f64):
        ckh = np.float32(ck)
        ckl = np.float32(np.float64(ck) - np.float64(ckh))
        shape = w[0][0].shape
        term = ((jnp.broadcast_to(jnp.float32(ckh), shape),
                 jnp.broadcast_to(jnp.float32(ckl), shape)),
                (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)))
        acc = term if acc is None else cdf_add(cdf_mul(acc, w), term)
    return acc


_CH_COEFF = [1.0 / math.factorial(2 * k) for k in range(_SERIES_TERMS)]
_SH_COEFF = [1.0 / math.factorial(2 * k + 1) for k in range(_SERIES_TERMS)]
_G_COEFF = [1.0 / math.factorial(2 * k + 2) - 1.0 / math.factorial(2 * k + 3)
            for k in range(_SERIES_TERMS)]


def _bo_step_cdf(q, r, lam, lam2, h: float, *, derivative: bool):
    """BO one-step matrix (and d/dlam) as cdf planes [..., 2, 2].

    q, r: cdf of shape [L, 1]; lam, lam2 = lam^2: cdf [1, K] (or [K]).
    Entries follow ops/scatter._cf_step_matrices with eps_t = h:
      U = [[ch - i lam sh, q sh], [r sh, ch + i lam sh]],
      ch = cosh(k h), sh = sinh(k h)/k, k^2 = q r - lam^2,
    all evaluated through even series in w = k^2 h^2 (module docstring).
    """
    ks = cdf_sub(cdf_mul(q, r), lam2)             # [L, K]
    w = _cdf_scale_host(ks, h * h)
    ch = _df_series_horner(w, _CH_COEFF)
    sh = _cdf_scale_host(_df_series_horner(w, _SH_COEFF), h)
    ilsh = _cdf_muli(cdf_mul(lam, sh))
    u00 = cdf_sub(ch, ilsh)
    u11 = cdf_add(ch, ilsh)
    u01 = cdf_mul(q, sh)
    u10 = cdf_mul(r, sh)

    def pack(m00, m01, m10, m11):
        def st(sel):
            return jnp.stack([
                jnp.stack([sel(m00), sel(m01)], axis=-1),
                jnp.stack([sel(m10), sel(m11)], axis=-1)], axis=-2)

        return ((st(lambda z: z[0][0]), st(lambda z: z[0][1])),
                (st(lambda z: z[1][0]), st(lambda z: z[1][1])))

    U = pack(u00, u01, u10, u11)
    if not derivative:
        return U, None
    g = _cdf_scale_host(_df_series_horner(w, _G_COEFF), h ** 3)
    lg = cdf_mul(lam, g)
    il2g = _cdf_muli(cdf_mul(lam2, g))            # i lam^2 g
    # (lam h + i) sh  and  (lam h - i) sh
    lh_sh = _cdf_scale_host(cdf_mul(lam, sh), h)
    ish = _cdf_muli(sh)
    d00 = cdf_sub(il2g, cdf_add(lh_sh, ish))
    d11 = cdf_sub(_cdf_neg(il2g), cdf_sub(lh_sh, ish))
    d01 = _cdf_neg(cdf_mul(q, lg))
    d10 = _cdf_neg(cdf_mul(r, lg))
    return U, pack(d00, d01, d10, d11)


def _cdf_mat_mul(b, a):
    """(b @ a) on cdf planes [..., 2, 2] (2x2 written out)."""
    def ent(z, i, j):
        return jax.tree.map(lambda t: t[..., i, j], z)

    rows = []
    for i in range(2):
        cols = []
        for j in range(2):
            t0 = cdf_mul(ent(b, i, 0), ent(a, 0, j))
            t1 = cdf_mul(ent(b, i, 1), ent(a, 1, j))
            cols.append(cdf_add(t0, t1))
        rows.append(jax.tree.map(lambda *xs: jnp.stack(xs, axis=-1), *cols))
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=-2), *rows)


def _cdf_mat_vec(m, v):
    """[..., 2, 2] cdf matrix times [..., 2] cdf vector."""
    def ent(z, i, j):
        return jax.tree.map(lambda t: t[..., i, j], z)

    def vent(z, i):
        return jax.tree.map(lambda t: t[..., i], z)

    outs = []
    for i in range(2):
        outs.append(cdf_add(cdf_mul(ent(m, i, 0), vent(v, 0)),
                            cdf_mul(ent(m, i, 1), vent(v, 1))))
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=-1), *outs)


def _pair_combine_cdf(a, b):
    """Associative (T, T') combine, later factors on the left."""
    am, ad = a
    bm, bd = b
    m = _cdf_mat_mul(bm, am)
    d = cdf_add(_cdf_mat_mul(bd, am), _cdf_mat_mul(bm, ad))
    return m, d


def _tree_product_cdf(u, du):
    """Product U[L-1] ... U[0] (+ derivative) over leading axis, log-depth."""
    def level(m, d):
        a = (jax.tree.map(lambda t: t[0::2], m),
             None if d is None else jax.tree.map(lambda t: t[0::2], d))
        b = (jax.tree.map(lambda t: t[1::2], m),
             None if d is None else jax.tree.map(lambda t: t[1::2], d))
        mm = _cdf_mat_mul(b[0], a[0])
        if d is None:
            return mm, None
        dd = cdf_add(_cdf_mat_mul(b[1], a[0]), _cdf_mat_mul(b[0], a[1]))
        return mm, dd

    n = jax.tree.leaves(u)[0].shape[0]
    assert n & (n - 1) == 0, "chunk length must be a power of two"
    while n > 1:
        u, du = level(u, du)
        n //= 2
    return (jax.tree.map(lambda t: t[0], u),
            None if du is None else jax.tree.map(lambda t: t[0], du))


def _mat_rescale(m, extra=None):
    """Per-K power-of-two rescale off the hi planes; returns (m, exp[K])."""
    hi = jnp.maximum(jnp.abs(m[0][0]), jnp.abs(m[1][0]))
    mx = jnp.max(hi, axis=(-2, -1))
    if extra is not None:
        ehi = jnp.maximum(jnp.abs(extra[0][0]), jnp.abs(extra[1][0]))
        mx = jnp.maximum(mx, jnp.max(ehi, axis=(-2, -1)))
    safe = jnp.where(mx > 0, mx, 1.0)
    a_exp = jnp.where(mx > 0, jnp.floor(jnp.log2(safe)), 0.0)
    scale = jnp.ldexp(jnp.float32(1.0), -a_exp.astype(jnp.int32))
    return scale, a_exp.astype(jnp.int32)


def pick_chunk_len(d: int, eps_t: float, im_max: float) -> int:
    """Largest power-of-two L (<= 1024) keeping exp(2 Im lam L eps) within
    f32 range with margin (|entries|^2 must stay finite for abs2)."""
    lim = 30.0 / max(2.0 * abs(im_max) * eps_t, 1e-12)
    l = 1
    while l * 2 <= min(d, 1024) and l * 2 <= lim:
        l *= 2
    return max(l, 1)


# ---------------------------------------------------------------------------
# stage 1: Newton refinement on a(lam)   (fnft_nsev.c:973-1038 semantics)
# ---------------------------------------------------------------------------

def _chunk_xs(q_cdf, chunk_len: int):
    d = q_cdf[0][0].shape[-1]
    c = d // chunk_len
    return jax.tree.map(lambda t: t.reshape((c, chunk_len, 1)), q_cdf)


def _lam_sq(lam):
    return cdf_mul(lam, lam)


def _scan_product(q_chunks, r_chunks, lam, h: float, *, derivative: bool):
    """Full product over all chunks: (T, T', w_exp) with per-chunk rescale.

    q_chunks: cdf [C, L, 1]; lam: cdf [K]. Returns T (cdf [K, 2, 2]),
    T' (or None), w_exp int32 [K].
    """
    k = lam[0][0].shape[-1]
    lam_b = jax.tree.map(lambda t: t[None, :], lam)
    lam2_b = _lam_sq(lam_b)

    eye = jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32), (k, 2, 2))
    t0 = ((eye, jnp.zeros_like(eye)),
          (jnp.zeros_like(eye), jnp.zeros_like(eye)))
    td0 = jax.tree.map(jnp.zeros_like, t0)

    def body(carry, xc):
        t, td, w = carry
        qc, rc_ = xc
        u, du = _bo_step_cdf(qc, rc_, lam_b, lam2_b, h,
                             derivative=derivative)
        m, d = _tree_product_cdf(u, du)
        t_new = _cdf_mat_mul(m, t)
        td_new = td
        if derivative:
            td_new = cdf_add(_cdf_mat_mul(d, t), _cdf_mat_mul(m, td))
        scale, a_exp = _mat_rescale(t_new, extra=td_new if derivative
                                    else None)
        sc = scale[:, None, None]
        t_new = _cdf_scale_pow2(t_new, sc)
        if derivative:
            td_new = _cdf_scale_pow2(td_new, sc)
        return (t_new, td_new, w + a_exp), None

    (t, td, w), _ = jax.lax.scan(
        body, (t0, td0, jnp.zeros((k,), jnp.int32)), (q_chunks, r_chunks))
    return t, (td if derivative else None), w


def _ent(m, i, j):
    return jax.tree.map(lambda t: t[..., i, j], m)


@partial(jax.jit, static_argnames=("niter", "h", "t_len", "chunk_len"))
def newton_stage_cdf(q_planes, lam_planes, box, niter: int, h: float,
                     t_len: float, chunk_len: int):
    """``niter`` Newton sweeps lam <- lam - a/a' in one XLA program.

    q_planes: (qrh, qrl, qih, qil) each [D]; lam_planes: 4 x [K];
    box: [4] f32 (re_min, re_max, im_min, im_max); t_len = te - tb.
    The 2^w rescale and the boundary phase e^{i lam t_len} cancel in the
    ratio a/a' up to the additive boundary term handled below:
      a  = T00 e^{i lam t_len} 2^w
      a' = (T00' + i t_len T00) e^{i lam t_len} 2^w.
    """
    qrh, qrl, qih, qil = q_planes
    q_cdf = ((qrh, qrl), (qih, qil))
    r_cdf = ((-qrh, -qrl), (qih, qil))            # r = -conj(q), kappa=+1
    q_chunks = _chunk_xs(q_cdf, chunk_len)
    r_chunks = _chunk_xs(r_cdf, chunk_len)

    def one_newton(_, carry):
        lam, active = carry
        t, td, _w = _scan_product(q_chunks, r_chunks, lam, h,
                                  derivative=True)
        a_hat = _ent(t, 0, 0)
        ap_hat = cdf_add(_ent(td, 0, 0),
                         _cdf_scale_host(_cdf_muli(a_hat), t_len))
        step = _cdf_div_guarded(a_hat, ap_hat)
        sr = step[0][0] + step[0][1]
        si = step[1][0] + step[1][1]
        # cdf_sub, NOT per-plane subtraction: hi - step_hi rounds away
        # any correction below ulp_f32(lam) instead of pushing it into
        # the lo plane, which capped Newton at ~1e-8 absolute on
        # hardware (the fullspec normconsts regression)
        lam_sub = cdf_sub(lam, step)
        lam_new = jax.tree.map(
            lambda new, old: jnp.where(active, new, old), lam_sub, lam)
        re = lam_new[0][0] + lam_new[0][1]
        im = lam_new[1][0] + lam_new[1][1]
        in_box = ((re >= box[0]) & (re <= box[1])
                  & (im >= box[2]) & (im <= box[3]))
        mag = jnp.sqrt(sr * sr + si * si)
        lmag = jnp.sqrt(re * re + im * im)
        active = active & (mag > _DF64_TOL * jnp.maximum(lmag, 1e-3)) \
            & in_box
        return lam_new, active

    lam0 = ((lam_planes[0], lam_planes[1]), (lam_planes[2], lam_planes[3]))
    k = lam_planes[0].shape[-1]
    lam, _ = jax.lax.fori_loop(0, niter, one_newton,
                               (lam0, jnp.ones((k,), bool)))
    return lam[0][0], lam[0][1], lam[1][0], lam[1][1]


# ---------------------------------------------------------------------------
# stage 2: a, a', b at the refined states (two-pass chunked phi/psi sweeps)
# ---------------------------------------------------------------------------

def _df_abs2(z):
    re, im = z
    return df_add(df_mul(re, re), df_mul(im, im))


def _metric_df(phi, psi):
    """Error metric 0.25 |log(|phi2 psi1|^2 / |phi1 psi2|^2)| in df64.

    Exponent side channels cancel (phi2/phi1 and psi1/psi2 ratios), so
    this is computed from the normalized values directly. Returns f32
    (hi-plane) metric — its ARGMIN only needs to resolve metric
    differences, and the df64 log argument keeps cancellation out.
    """
    def vent(z, i):
        return jax.tree.map(lambda t: t[..., i], z)

    num = _df_abs2(cdf_mul(vent(phi, 1), vent(psi, 0)))
    den = _df_abs2(cdf_mul(vent(phi, 0), vent(psi, 1)))
    tiny = jnp.float32(np.finfo(np.float32).tiny)
    ln = df_sub(df_log((jnp.maximum(num[0], tiny), num[1])),
                df_log((jnp.maximum(den[0], tiny), den[1])))
    bad = (num[0] <= 0) | (den[0] <= 0)
    return jnp.where(bad, jnp.inf, 0.25 * jnp.abs(ln[0] + ln[1]))


@partial(jax.jit, static_argnames=("h", "chunk_len"))
def ab_stage_cdf(q_planes, lam_planes, h: float, chunk_len: int):
    """a-hat, a'-hat, b-hat and exponents at bound states, one program.

    Returns a dict of planes; the host recombines with boundary phases:
      a  = a_hat 2^{wa} e^{i lam (te - tb)}
      a' = (ap_hat + i (te-tb) a_hat) 2^{wa} e^{i lam (te - tb)}
      b  = b_hat 2^{wb} e^{-i lam (tb + te)}
    (phi is normalized from [1, 0] at tb, psi from [0, 1] at te; the
    dropped phases e^{-i lam tb}, e^{i lam te} reappear in the host
    formulas). Reference: fnft__nse_scatter_bound_states.c:29-668 with
    the DOI 10.1109/ACCESS.2019.2932256 error-metric argmin for b.
    """
    qrh, qrl, qih, qil = q_planes
    q_cdf = ((qrh, qrl), (qih, qil))
    r_cdf = ((-qrh, -qrl), (qih, qil))
    q_chunks = _chunk_xs(q_cdf, chunk_len)
    r_chunks = _chunk_xs(r_cdf, chunk_len)
    lam = ((lam_planes[0], lam_planes[1]), (lam_planes[2], lam_planes[3]))
    k = lam_planes[0].shape[-1]
    lam_b = jax.tree.map(lambda t: t[None, :], lam)
    lam2_b = _lam_sq(lam_b)

    # ---- pass 1 forward: chunk products w/ derivative; store left-edge phi
    eye = jnp.broadcast_to(jnp.eye(2, dtype=jnp.float32), (k, 2, 2))
    t0 = ((eye, jnp.zeros_like(eye)),
          (jnp.zeros_like(eye), jnp.zeros_like(eye)))
    td0 = jax.tree.map(jnp.zeros_like, t0)

    def fwd_body(carry, xc):
        t, td, w = carry
        qc, rc_ = xc
        u, du = _bo_step_cdf(qc, rc_, lam_b, lam2_b, h, derivative=True)
        m, d = _tree_product_cdf(u, du)
        t_new = _cdf_mat_mul(m, t)
        td_new = cdf_add(_cdf_mat_mul(d, t), _cdf_mat_mul(m, td))
        scale, a_exp = _mat_rescale(t_new, extra=td_new)
        sc = scale[:, None, None]
        t_new = _cdf_scale_pow2(t_new, sc)
        td_new = _cdf_scale_pow2(td_new, sc)
        # phi at this chunk's LEFT edge = previous T @ [1, 0] = column 0
        phi_left = jax.tree.map(lambda x: x[..., :, 0], t)
        return (t_new, td_new, w + a_exp), (phi_left, w)

    (t_end, td_end, w_a), (phi_lefts, w_phi) = jax.lax.scan(
        fwd_body, (t0, td0, jnp.zeros((k,), jnp.int32)),
        (q_chunks, r_chunks))

    a_hat = _ent(t_end, 0, 0)
    ap_hat = _ent(td_end, 0, 0)

    # ---- pass 1 backward: psi chunk products; store right-edge psi -------
    def bwd_body(carry, xc):
        s, w = carry
        qc, rc_ = xc
        qr = jax.tree.map(lambda t_: t_[::-1], qc)
        rr = jax.tree.map(lambda t_: t_[::-1], rc_)
        u, _ = _bo_step_cdf(qr, rr, lam_b, lam2_b, -h, derivative=False)
        m, _ = _tree_product_cdf(u, None)
        # m = U_b(first) ... U_b(last of reversed) = product undoing the
        # chunk right-to-left; psi_left_edge = m @ psi_right_edge
        s_new = _cdf_mat_mul(m, s)
        scale, a_exp = _mat_rescale(s_new)
        s_new = _cdf_scale_pow2(s_new, scale[:, None, None])
        psi_right = jax.tree.map(lambda x: x[..., :, 1], s)  # column 1
        return (s_new, w + a_exp), (psi_right, w)

    (s_end, _w_s), (psi_rights_rev, w_psi_rev) = jax.lax.scan(
        bwd_body, (t0, jnp.zeros((k,), jnp.int32)),
        jax.tree.map(lambda t_: t_[::-1], (q_chunks, r_chunks)))
    psi_rights = jax.tree.map(lambda t_: t_[::-1], psi_rights_rev)
    w_psi = w_psi_rev[::-1]
    psi0 = jax.tree.map(lambda x: x[..., :, 1], s_end)
    w_psi0 = _w_s

    # ---- pass 2: stream the error-metric argmin over all grid points -----
    def metric_body(carry, inp):
        best_m, b_num, b_den, b_dw = carry
        qc, rc_, phi_l, w_p, psi_r, w_q = inp
        u, _ = _bo_step_cdf(qc, rc_, lam_b, lam2_b, h, derivative=False)
        # inclusive prefix products (later factors left): positions 1..L
        pref = jax.lax.associative_scan(
            lambda a, b: _cdf_mat_mul(b, a), u, axis=0)
        phi_vals = _cdf_mat_vec(pref, jax.tree.map(
            lambda t_: t_[None], phi_l))                     # [L, K, 2]
        ub, _ = _bo_step_cdf(jax.tree.map(lambda t_: t_[::-1], qc),
                             jax.tree.map(lambda t_: t_[::-1], rc_),
                             lam_b, lam2_b, -h, derivative=False)
        prefb = jax.lax.associative_scan(
            lambda a, b: _cdf_mat_mul(b, a), ub, axis=0)
        psi_rev = _cdf_mat_vec(prefb, jax.tree.map(
            lambda t_: t_[None], psi_r))                     # [L, K, 2]
        # psi at positions cL .. (c+1)L-1 (ascending): reverse, drop edge
        psi_vals = jax.tree.map(
            lambda rev, right: jnp.concatenate(
                [rev[::-1][1:], right[None]], axis=0),
            psi_rev, psi_r)
        m_loc = _metric_df(phi_vals, psi_vals)               # [L, K] f32
        j = jnp.argmin(m_loc, axis=0)
        m_best = jnp.take_along_axis(m_loc, j[None, :], axis=0)[0]

        def pick(z):
            return jax.tree.map(
                lambda t_: jnp.take_along_axis(
                    t_, j[None, :, None], axis=0)[0], z)

        phi_best = pick(phi_vals)
        psi_best = pick(psi_vals)
        better = m_best < best_m
        num = jax.tree.map(lambda t_: t_[..., 0], phi_best)
        den = jax.tree.map(lambda t_: t_[..., 0], psi_best)
        dw = w_p - w_q

        def sel(new, old):
            return jax.tree.map(
                lambda a, b_: jnp.where(better, a, b_), new, old)

        return (jnp.where(better, m_best, best_m), sel(num, b_num),
                sel(den, b_den), jnp.where(better, dw, b_dw)), None

    phi0_vec = jax.tree.map(lambda x: x[..., :, 0], t0)
    m0 = _metric_df(phi0_vec, psi0)
    num0 = jax.tree.map(lambda t_: t_[..., 0], phi0_vec)
    den0 = jax.tree.map(lambda t_: t_[..., 0], psi0)
    (best_m, b_num, b_den, b_dw), _ = jax.lax.scan(
        metric_body, (m0, num0, den0, -w_psi0),
        (q_chunks, r_chunks, phi_lefts, w_phi, psi_rights, w_psi))
    b_hat = _cdf_div_guarded(b_num, b_den)

    def planes(z):
        return (z[0][0], z[0][1], z[1][0], z[1][1])

    return dict(a_hat=planes(a_hat), ap_hat=planes(ap_hat),
                b_hat=planes(b_hat), w_a=w_a, w_b=b_dw,
                metric=best_m)


# ---------------------------------------------------------------------------
# eager (CPU) drivers: same chunk math, python loops, host-f64 composition
# ---------------------------------------------------------------------------
# XLA:CPU's optimizer is pathologically slow on the deep df64 EFT chains
# (a single L=32 chunk kernel fails to compile in minutes — the same alarm
# ops/df64_pipeline.py documents), so on the CPU backend the chunk math
# runs EAGERLY and the [K, 2, 2] chunk products are composed on the host
# in float64 (where exp(+-Im lam T) needs no rescale side channel). The
# fused lax.scan stages below run on accelerator backends only.

def _chunk_product_eager(q_chunk_cdf, r_chunk_cdf, lam, lam2, h: float,
                         derivative: bool):
    """One chunk's (M, dM) as host complex128 [K, 2, 2] (eager ops)."""
    u, du = _bo_step_cdf(q_chunk_cdf, r_chunk_cdf, lam, lam2, h,
                         derivative=derivative)
    m, d = _tree_product_cdf(u, du)

    def join(z):
        return (np.asarray(z[0][0], np.float64) + np.asarray(z[0][1], np.float64)
                + 1j * (np.asarray(z[1][0], np.float64)
                        + np.asarray(z[1][1], np.float64)))

    return join(m), (join(d) if derivative else None)


def _eager_inputs(q128, lam, chunk_len):
    d = q128.shape[-1]
    c = d // chunk_len
    q_cdf = cdf_from_c128(q128.reshape(c, chunk_len))
    lam_cdf = cdf_from_c128(np.asarray(lam, np.complex128))
    lam_b = jax.tree.map(lambda t: t[None, :], lam_cdf)
    lam2_b = _lam_sq(lam_b)

    def chunk(i):
        qc = jax.tree.map(lambda t: t[i][:, None], q_cdf)
        rc_ = ((-qc[0][0], -qc[0][1]), (qc[1][0], qc[1][1]))
        return qc, rc_

    return c, chunk, lam_b, lam2_b


def _newton_eager(q128, lam0, h, te_minus_tb, box, niter, chunk_len):
    lam = np.asarray(lam0, np.complex128).copy()
    k = lam.shape[0]
    active = np.ones(k, bool)
    for _ in range(niter):
        if not active.any():
            break
        c, chunk, lam_b, lam2_b = _eager_inputs(q128, lam, chunk_len)
        t = np.broadcast_to(np.eye(2, dtype=np.complex128),
                            (k, 2, 2)).copy()
        td = np.zeros_like(t)
        for i in range(c):
            qc, rc_ = chunk(i)
            m, dm = _chunk_product_eager(qc, rc_, lam_b, lam2_b, h, True)
            td = dm @ t + m @ td
            t = m @ t
            # keep f64 range healthy for the next host product
            scale = 2.0 ** -np.floor(np.log2(np.maximum(
                np.abs(t).max(axis=(-2, -1)), 1e-300)))
            t *= scale[:, None, None]
            td *= scale[:, None, None]
        a_hat = t[:, 0, 0]
        ap_hat = td[:, 0, 0] + 1j * te_minus_tb * a_hat
        step = np.where(ap_hat == 0, 0.0, a_hat / np.where(ap_hat == 0,
                                                           1.0, ap_hat))
        lam_new = np.where(active, lam - step, lam)
        in_box = ((lam_new.real >= box[0]) & (lam_new.real <= box[1])
                  & (lam_new.imag >= box[2]) & (lam_new.imag <= box[3]))
        active = active & (np.abs(step)
                           > _DF64_TOL * np.maximum(np.abs(lam_new), 1e-3)) \
            & in_box
        lam = lam_new
    return lam


def _prefix_products_eager(u):
    """Inclusive prefix products (later factors left) over leading axis."""
    n = jax.tree.leaves(u)[0].shape[0]
    import math as _math

    levels = int(_math.ceil(_math.log2(max(n, 1)))) if n > 1 else 0
    pref = u
    for lv in range(levels):
        ofs = 1 << lv

        def shift(t):
            pad = [(ofs, 0)] + [(0, 0)] * (t.ndim - 1)
            return jnp.pad(t, pad)[:n]

        shifted = jax.tree.map(shift, pref)
        prod = _cdf_mat_mul(pref, shifted)
        # positions < ofs keep their current value (identity on the left
        # would be wrong: combine is pref[i] @ pref[i-ofs])
        mask = (jnp.arange(n) >= ofs).astype(jnp.float32)
        mk = mask[(slice(None),) + (None,) * (jax.tree.leaves(u)[0].ndim - 1)]
        pref = jax.tree.map(lambda new, old: new * mk + old * (1 - mk),
                            prod, pref)
    return pref


def _ab_eager(q128, lam, h, chunk_len):
    lam = np.asarray(lam, np.complex128)
    k = lam.shape[0]
    c, chunk, lam_b, lam2_b = _eager_inputs(q128, lam, chunk_len)
    # pass 1 forward: chunk products, phi at chunk left edges (host f64)
    t = np.broadcast_to(np.eye(2, dtype=np.complex128), (k, 2, 2)).copy()
    td = np.zeros_like(t)
    phi_lefts = np.zeros((c, k, 2), np.complex128)
    ms = []
    for i in range(c):
        qc, rc_ = chunk(i)
        m, dm = _chunk_product_eager(qc, rc_, lam_b, lam2_b, h, True)
        ms.append(m)
        phi_lefts[i] = t[:, :, 0]
        td = dm @ t + m @ td
        t = m @ t
    a_hat = t[:, 0, 0]
    ap_hat = td[:, 0, 0]
    # pass 1 backward: psi at chunk right edges
    s = np.broadcast_to(np.eye(2, dtype=np.complex128), (k, 2, 2)).copy()
    psi_rights = np.zeros((c, k, 2), np.complex128)
    for i in range(c - 1, -1, -1):
        qc, rc_ = chunk(i)
        mb, _ = _chunk_product_eager(
            jax.tree.map(lambda t_: t_[::-1], qc),
            jax.tree.map(lambda t_: t_[::-1], rc_), lam_b, lam2_b, -h, False)
        psi_rights[i] = s[:, :, 1]
        s = mb @ s
    psi0 = s[:, :, 1]
    # pass 2: error-metric argmin streamed over chunks (host f64 metric)
    def metric_np(phi, psi):
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = (phi[..., 1] / psi[..., 1]) / (phi[..., 0] / psi[..., 0])
            m_ = np.abs(0.5 * np.log(np.abs(ratio)))
        return np.where(np.isnan(m_), np.inf, m_)

    phi0 = np.broadcast_to(np.array([1.0, 0.0], np.complex128), (k, 2))
    best_m = metric_np(phi0, psi0)
    best_b = phi0[:, 0] / psi0[:, 0]
    for i in range(c):
        qc, rc_ = chunk(i)
        u, _ = _bo_step_cdf(qc, rc_, lam_b, lam2_b, h, derivative=False)
        pref = _prefix_products_eager(u)
        pref_np = (np.asarray(pref[0][0], np.float64)
                   + np.asarray(pref[0][1], np.float64)
                   + 1j * (np.asarray(pref[1][0], np.float64)
                           + np.asarray(pref[1][1], np.float64)))
        phi_vals = np.einsum("lkij,kj->lki", pref_np, phi_lefts[i])
        ub, _ = _bo_step_cdf(jax.tree.map(lambda t_: t_[::-1], qc),
                             jax.tree.map(lambda t_: t_[::-1], rc_),
                             lam_b, lam2_b, -h, derivative=False)
        prefb = _prefix_products_eager(ub)
        prefb_np = (np.asarray(prefb[0][0], np.float64)
                    + np.asarray(prefb[0][1], np.float64)
                    + 1j * (np.asarray(prefb[1][0], np.float64)
                            + np.asarray(prefb[1][1], np.float64)))
        psi_rev = np.einsum("lkij,kj->lki", prefb_np, psi_rights[i])
        psi_vals = np.concatenate([psi_rev[::-1][1:],
                                   psi_rights[i][None]], axis=0)
        m_loc = metric_np(phi_vals, psi_vals)
        j = np.argmin(m_loc, axis=0)
        m_best = m_loc[j, np.arange(k)]
        b_cand = phi_vals[j, np.arange(k), 0] / psi_vals[j, np.arange(k), 0]
        better = m_best < best_m
        best_m = np.where(better, m_best, best_m)
        best_b = np.where(better, b_cand, best_b)
    return a_hat, ap_hat, best_b, best_m


# ---------------------------------------------------------------------------
# host drivers
# ---------------------------------------------------------------------------

def _split_planes(z128: np.ndarray):
    re, im = np.real(z128), np.imag(z128)
    rh = re.astype(np.float32)
    rl = (re - rh.astype(np.float64)).astype(np.float32)
    ih = im.astype(np.float32)
    il = (im - ih.astype(np.float64)).astype(np.float32)
    return (jnp.asarray(rh), jnp.asarray(rl),
            jnp.asarray(ih), jnp.asarray(il))


def _join_planes(p) -> np.ndarray:
    return (np.asarray(p[0], np.float64) + np.asarray(p[1], np.float64)
            + 1j * (np.asarray(p[2], np.float64)
                    + np.asarray(p[3], np.float64)))


def newton_refine_df64(q128, lam0, t_span, *, niter: int = 10,
                       bounding_box=None, chunk_len: int | None = None):
    """Newton-refine bound-state candidates at full D in df64.

    q128: complex128 [D] (D a power of two); lam0: complex128 [K]
    candidates; returns refined complex128 [K]. BO base scheme,
    matching the reference's SUBSAMPLE_AND_REFINE refinement stage
    (fnft_nsev.c:673-741) at c128-equivalent precision on an f32 device.
    """
    q128 = np.asarray(q128, np.complex128)
    lam0 = np.asarray(lam0, np.complex128)
    d = q128.shape[-1]
    if d & (d - 1):
        raise ValueError("D must be a power of two")
    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / (d - 1)
    tb = t0 - 0.5 * eps_t
    te = t1 + 0.5 * eps_t
    if bounding_box is None:
        bounding_box = (-np.inf, np.inf, 0.0, np.inf)
    im_max = min(float(bounding_box[3]),
                 float(np.max(np.abs(np.imag(lam0))) + 2.0) if lam0.size
                 else 2.0)
    if chunk_len is None:
        chunk_len = pick_chunk_len(d, eps_t, max(im_max, 1.0))
    if jax.default_backend() == "cpu":
        # eager chunk math + host-f64 composition (see eager section)
        return _newton_eager(q128, lam0, float(eps_t), float(te - tb),
                             bounding_box, int(niter), int(chunk_len))
    box = jnp.asarray(np.clip(np.asarray(bounding_box, np.float64),
                              -3e38, 3e38).astype(np.float32))
    out = newton_stage_cdf(_split_planes(q128), _split_planes(lam0), box,
                           int(niter), float(eps_t), float(te - tb),
                           int(chunk_len))
    return _join_planes(out)


def ab_at_states_df64(q128, lam, t_span, *, chunk_len: int | None = None):
    """(a, a', b) at bound states in df64; complex128 in/out.

    Host recombination happens here in float64 (the exp(+-Im lam T)
    factors overflow f32 but not f64). Reference semantics:
    fnft_nsev.c:895-970 -> nse_scatter_bound_states.
    """
    q128 = np.asarray(q128, np.complex128)
    lam = np.asarray(lam, np.complex128)
    d = q128.shape[-1]
    if d & (d - 1):
        raise ValueError("D must be a power of two")
    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / (d - 1)
    tb = t0 - 0.5 * eps_t
    te = t1 + 0.5 * eps_t
    im_max = float(np.max(np.abs(np.imag(lam)))) + 1.0 if lam.size else 2.0
    if chunk_len is None:
        chunk_len = pick_chunk_len(d, eps_t, max(im_max, 1.0))
    if jax.default_backend() == "cpu":
        a_hat, ap_hat, b_hat, _m = _ab_eager(q128, lam, float(eps_t),
                                             int(chunk_len))
        phase_a = np.exp(1j * lam * (te - tb))
        a = a_hat * phase_a
        aprime = (ap_hat + 1j * (te - tb) * a_hat) * phase_a
        b = b_hat * np.exp(-1j * lam * (tb + te))
        return a, aprime, b
    out = ab_stage_cdf(_split_planes(q128), _split_planes(lam),
                       float(eps_t), int(chunk_len))
    a_hat = _join_planes(out["a_hat"])
    ap_hat = _join_planes(out["ap_hat"])
    b_hat = _join_planes(out["b_hat"])
    w_a = np.asarray(out["w_a"], np.int64)
    w_b = np.asarray(out["w_b"], np.int64)
    phase_a = np.exp(1j * lam * (te - tb)) * np.exp2(w_a.astype(np.float64))
    a = a_hat * phase_a
    aprime = (ap_hat + 1j * (te - tb) * a_hat) * phase_a
    b = b_hat * np.exp2(w_b.astype(np.float64)) * np.exp(-1j * lam * (tb + te))
    return a, aprime, b
