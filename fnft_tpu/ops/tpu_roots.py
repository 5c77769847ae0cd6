"""Real-pair Ehrlich–Aberth rootfinding for complex-free backends.

On a backend that lowers no complex-typed HLO, :mod:`fnft_tpu.ops.roots`
— the eiscor replacement — cannot run as written. This module lowers the same algorithm (block-Horner Newton ratio,
pairwise repulsion, Bini Newton-polygon initialization, freeze-on-converge
sweeps) to (re, im) float32 pairs via :mod:`fnft_tpu.ops.rc`: the hot
O(deg^2) repulsion and the [nch, CHUNK] x [CHUNK, K] Vandermonde
contractions become pure real f32 elementwise/matmul work.

Used for on-device bound-state localization: the subsampled a-polynomial
from the rc SPLIT4B tree (ops/tpu_pipeline.py) is rootfound here, and the
candidates are Newton-refined at full D in df64 (ops/df64_boundstates.py).
Reference being matched: fnft_nsev.c:595-741 (SUBSAMPLE_AND_REFINE
localization via fnft__poly_roots_fasteigen/eiscor); accuracy contract of
this stage is only "good Newton seeds", so f32 is sufficient (the f32
freeze tolerance ~1e-5 is far below the subsample discretization error).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from fnft_tpu.ops import rc
from fnft_tpu.ops.roots import newton_polygon_polar_jax

_CHUNK = 64          # block-Horner chunk (matches ops/roots._CHUNK)
_F32_TOL = 100.0 * float(np.finfo(np.float32).eps)


def _matmul_rc(a: rc.Pair, b: rc.Pair) -> rc.Pair:
    """Complex matmul as four real matmuls (full float32: no TF32)."""
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    return (mm(a[0], b[0]) - mm(a[1], b[1]), mm(a[0], b[1]) + mm(a[1], b[0]))


def _inv_rc(z: rc.Pair) -> rc.Pair:
    """1/z with a z==0 guard (returns 0 there, as ops/roots does)."""
    d = rc.abs2(z)
    zero = d == 0
    inv = 1.0 / jnp.where(zero, 1.0, d)
    return (jnp.where(zero, 0.0, z[0] * inv),
            jnp.where(zero, 0.0, -z[1] * inv))


def _vandermonde_rc(x: rc.Pair, n: int) -> rc.Pair:
    """Powers x^0..x^{n-1} stacked on axis 0: [n, K] pair (log-depth)."""
    ones = (jnp.ones_like(x[0]), jnp.zeros_like(x[1]))
    tiles = (jnp.concatenate([ones[0][None],
                              jnp.tile(x[0][None], (n - 1, 1))], axis=0),
             jnp.concatenate([ones[1][None],
                              jnp.tile(x[1][None], (n - 1, 1))], axis=0))
    return jax.lax.associative_scan(rc.mul, tiles, axis=0)


def _block_eval_ratio_rc(coeffs: rc.Pair, z: rc.Pair) -> rc.Pair:
    """w = p(z)/p'(z) in real pairs (ops/roots._block_eval_ratio lowered).

    Same inside/outside unit-disk split through the reversed polynomial so
    only ratios are formed; the per-chunk contraction cs_p @ Vandermonde
    is four real [nch, CHUNK] x [CHUNK, K] matmuls.
    """
    deg = coeffs[0].shape[-1] - 1
    kvec = jnp.arange(deg + 1, dtype=coeffs[0].dtype)

    inside = rc.abs2(z) <= 1.0
    zinv = _inv_rc(z)
    u = (jnp.where(inside, z[0], zinv[0]), jnp.where(inside, z[1], zinv[1]))

    xp = _vandermonde_rc(u, _CHUNK)                     # [CHUNK, K]
    x_l = rc.mul((xp[0][-1], xp[1][-1]), u)             # u^CHUNK [K]

    def eval_pair(cs: rc.Pair, ks: rc.Pair):
        n = cs[0].shape[-1]
        nch = -(-n // _CHUNK)
        pad = nch * _CHUNK - n

        def prep(t):
            return jnp.pad(t, (0, pad)).reshape(nch, _CHUNK)

        inner_p = _matmul_rc(rc.apply(prep, cs), xp)    # [nch, K]
        inner_s = _matmul_rc(rc.apply(prep, ks), xp)

        def step(carry, inners):
            accp, accs = carry
            ipr, ipi, isr, isi = inners
            accp = rc.add(rc.mul(accp, x_l), (ipr, ipi))
            accs = rc.add(rc.mul(accs, x_l), (isr, isi))
            return (accp, accs), None

        z0 = rc.zeros(u[0].shape, u[0].dtype)
        (pv, sv), _ = jax.lax.scan(
            step, (z0, z0),
            (inner_p[0][::-1], inner_p[1][::-1],
             inner_s[0][::-1], inner_s[1][::-1]))
        return pv, sv

    ks_fwd = (coeffs[0] * kvec, coeffs[1] * kvec)
    p_in, s_in = eval_pair(coeffs, ks_fwd)
    rev = rc.apply(lambda t: t[::-1], coeffs)
    ks_rev = (rev[0] * kvec, rev[1] * kvec)
    p_rev, s_rev = eval_pair(rev, ks_rev)

    # inside: p'/p = s_in / (u * p_in); outside: p'/p = u*(deg - s_rev/q)
    pin_zero = rc.abs2(p_in) == 0
    lg_in = rc.mul(s_in, _inv_rc(rc.mul(u, p_in)))
    prev_zero = rc.abs2(p_rev) == 0
    ratio_rev = rc.mul(s_rev, _inv_rc(p_rev))
    lg_out = rc.mul(u, (deg - ratio_rev[0], -ratio_rev[1]))
    log_deriv = (jnp.where(inside, lg_in[0], lg_out[0]),
                 jnp.where(inside, lg_in[1], lg_out[1]))
    p_is_zero = jnp.where(inside, pin_zero, prev_zero)
    w = _inv_rc(log_deriv)
    return (jnp.where(p_is_zero, 0.0, w[0]),
            jnp.where(p_is_zero, 0.0, w[1]))


def _repulsion_rc(z_all: rc.Pair, z_t: rc.Pair, t_idx) -> rc.Pair:
    """s_i = sum_{j != t_idx_i} 1/(z_t_i - z_all_j), chunked over j.

    Real-pair form of ops/roots._repulsion_chunked (already f32 there:
    the repulsion only steers the iteration path, not the fixed point).
    """
    deg = z_all[0].shape[0]
    m = z_t[0].shape[0]
    chunk = max(512, min(1 << 16, (1 << 26) // max(m, 1)))
    nch = -(-deg // chunk)
    zp = rc.apply(lambda t: jnp.pad(t, (0, nch * chunk - deg)), z_all)

    def body(c, acc):
        zc = rc.apply(
            lambda t: jax.lax.dynamic_slice_in_dim(t, c * chunk, chunk), zp)
        jc = c * chunk + jnp.arange(chunk)
        diff = (z_t[0][:, None] - zc[0][None, :],
                z_t[1][:, None] - zc[1][None, :])
        bad = (t_idx[:, None] == jc[None, :]) | (jc[None, :] >= deg)
        d2 = rc.abs2(diff)
        inv = jnp.where(bad, 0.0, 1.0 / jnp.where(bad | (d2 == 0), 1.0, d2))
        return (acc[0] + jnp.sum(diff[0] * inv, axis=1),
                acc[1] + jnp.sum(-diff[1] * inv, axis=1))

    return jax.lax.fori_loop(
        0, nch, body, (jnp.zeros_like(z_t[0]), jnp.zeros_like(z_t[1])))


def newton_polygon_init_rc(coeffs: rc.Pair) -> rc.Pair:
    """Bini initial guesses from pair coefficients (no complex HLO)."""
    radius, ang = newton_polygon_polar_jax(rc.cabs(coeffs))
    return radius * jnp.cos(ang), radius * jnp.sin(ang)


@partial(jax.jit, static_argnames=("num_iters",))
def aberth_rc(coeffs_re, coeffs_im, z0_re, z0_im, num_iters: int = 60):
    """Ehrlich–Aberth sweeps in real f32 pairs (ops/roots.aberth_roots).

    Same freeze rule, early exit, and golden-angle stagnation kick as the
    complex implementation; tolerance is the f32 analogue (100 eps_f32).
    Returns (roots_re, roots_im) of shape [deg].
    """
    coeffs = (jnp.asarray(coeffs_re), jnp.asarray(coeffs_im))
    z0 = (jnp.asarray(z0_re), jnp.asarray(z0_im))
    deg = coeffs[0].shape[-1] - 1
    tol = jnp.float32(_F32_TOL)
    idx = jnp.arange(deg)

    def sweep(state):
        zr, zi, frozen, _, it = state
        z = (zr, zi)
        w = _block_eval_ratio_rc(coeffs, z)
        s = _repulsion_rc(z, z, idx)
        denom = rc.sub((jnp.ones_like(zr), jnp.zeros_like(zr)), rc.mul(w, s))
        corr = rc.mul(w, _inv_rc(denom))
        # denom == 0 exactly: fall back to the pure Newton step w
        dz = rc.abs2(denom) == 0
        corr = (jnp.where(dz, w[0], corr[0]), jnp.where(dz, w[1], corr[1]))
        z_new = (jnp.where(frozen, zr, zr - corr[0]),
                 jnp.where(frozen, zi, zi - corr[1]))
        rel = rc.cabs(corr) / jnp.maximum(rc.cabs(z_new), 1e-30)
        frozen = frozen | (rel < tol)
        moved = jnp.max(jnp.where(frozen, 0.0, rel))
        return z_new[0], z_new[1], frozen, moved, it + 1

    def cond(state):
        _, _, _, moved, it = state
        return (moved > tol) & (it < num_iters)

    def run(z_init, frozen_init, iters):
        return jax.lax.while_loop(
            cond, sweep, (z_init[0], z_init[1], frozen_init,
                          jnp.float32(jnp.inf), iters))

    zr, zi, frozen, _, it = run(z0, jnp.zeros(deg, bool), jnp.int32(0))

    def restart(args):
        zr_, zi_, frozen_ = args
        kick = 1.0 + 64.0 * tol * jnp.cos(
            jnp.arange(deg, dtype=jnp.float32) * 2.399963229728653)
        zkr = jnp.where(frozen_, zr_, zr_ * kick)
        zki = jnp.where(frozen_, zi_, zi_ * kick)
        r2 = run((zkr, zki), frozen_, jnp.int32(num_iters // 2))
        return r2[0], r2[1]

    zr, zi = jax.lax.cond(jnp.all(frozen), lambda a: (a[0], a[1]), restart,
                          (zr, zi, frozen))
    return zr, zi


def poly_roots_rc(coeffs: rc.Pair, num_iters: int = 60) -> rc.Pair:
    """All roots from pair coefficients: polygon init + Aberth sweeps."""
    z0 = newton_polygon_init_rc(coeffs)
    return aberth_rc(coeffs[0], coeffs[1], z0[0], z0[1],
                     num_iters=num_iters)


# ---------------------------------------------------------------------------
# df64 Newton polish + backward-error certification (eiscor's contract at
# c128 tolerance, on a device with neither c128 nor f64)
# ---------------------------------------------------------------------------

def _cdf_horner_pair(coeffs_cdf, kcoeffs_cdf, u_cdf, chunk: int = 64,
                     use_scan: bool = True):
    """(p(u), s(u) = sum k c_k u^k) in cdf block-Horner.

    coeffs as cdf [nch, chunk] (pre-reshaped); u as cdf [K]. The scan depth
    is nch = ceil((deg+1)/chunk); each step is chunk unrolled cdf
    multiply-adds on [K] lanes. ``use_scan=False`` loops on the
    host instead (the eager CPU mode — XLA:CPU cannot compile the deep
    df64 chains, ops/df64_boundstates.py documents the pathology).
    """
    from fnft_tpu.ops.df64 import cdf_add, cdf_mul

    # Vandermonde u^0..u^{chunk-1} as a list of cdf [K] (built once)
    one = ((jnp.ones_like(u_cdf[0][0]), jnp.zeros_like(u_cdf[0][0])),
           (jnp.zeros_like(u_cdf[0][0]), jnp.zeros_like(u_cdf[0][0])))
    powers = [one]
    for _ in range(chunk - 1):
        powers.append(cdf_mul(powers[-1], u_cdf))
    u_chunk = cdf_mul(powers[-1], u_cdf)         # u^chunk

    def body(carry, cs):
        accp, accs = carry
        c_ck, k_ck = cs                           # cdf [chunk] each

        def contract(ck):
            acc = None
            for j in range(chunk):
                cj = jax.tree.map(lambda t: t[j], ck)    # cdf scalar
                term = cdf_mul(jax.tree.map(
                    lambda t: jnp.broadcast_to(t, u_cdf[0][0].shape), cj),
                    powers[j])
                acc = term if acc is None else cdf_add(acc, term)
            return acc

        accp = cdf_add(cdf_mul(accp, u_chunk), contract(c_ck))
        accs = cdf_add(cdf_mul(accs, u_chunk), contract(k_ck))
        return (accp, accs), None

    zero = jax.tree.map(jnp.zeros_like, one)
    rev = jax.tree.map(lambda t: t[::-1], (coeffs_cdf, kcoeffs_cdf))
    if use_scan:
        (p, s), _ = jax.lax.scan(body, (zero, zero), rev)
        return p, s
    nch = rev[0][0][0].shape[0]
    carry = (zero, zero)
    for i in range(nch):
        carry, _ = body(carry, jax.tree.map(lambda t: t[i], rev))
    return carry


def _reshape_chunks_cdf(c_cdf, chunk: int):
    n = c_cdf[0][0].shape[-1]
    nch = -(-n // chunk)
    pad = nch * chunk - n

    def prep(t):
        return jnp.pad(t, (0, pad)).reshape(nch, chunk)

    return jax.tree.map(prep, c_cdf), nch


def polish_certify_cdf(coeffs128: np.ndarray, roots: np.ndarray,
                       iters: int = 3):
    """df64 Newton polish of f32 Aberth roots + Mosier backward error.

    Host complex128 in/out; on-device everything is float32 planes. The
    inside/outside unit-disk split is resolved on the HOST (roots are
    concrete), so each subset evaluates only its stable form: the forward
    polynomial at z inside, the reversed polynomial at u = 1/z outside
    (ops/roots._block_eval_ratio's scheme). Returns (roots, eta) with
    eta the per-root relative backward error — same certificate contract
    as ops/roots.root_residuals / eiscor backward stability.
    """
    from fnft_tpu.ops.df64 import (cdf_add, cdf_from_c128, cdf_mul,
                                   cdf_sub, cdf_to_c128)
    from fnft_tpu.ops.df64_boundstates import _cdf_div_guarded, _cdf_muli

    coeffs128 = np.asarray(coeffs128, np.complex128)
    roots = np.asarray(roots, np.complex128)
    deg = coeffs128.shape[-1] - 1
    kvec = np.arange(deg + 1, dtype=np.float64)

    inside = np.abs(roots) <= 1.0
    out = roots.copy()
    eta = np.zeros(roots.shape, np.float64)

    def _prep(cs):
        c_cdf = cdf_from_c128(cs)
        k_cdf = cdf_from_c128(cs * kvec)
        cc, _ = _reshape_chunks_cdf(c_cdf, 64)
        kk, _ = _reshape_chunks_cdf(k_cdf, 64)
        abs_c = np.abs(cs)
        return cc, kk, jnp.asarray(abs_c.astype(np.float32))

    def _run(cs_prepped, u0: np.ndarray):
        cc, kk, abs_c = cs_prepped
        k = u0.shape[0]
        k_pad = 1 << max(0, (k - 1)).bit_length()
        u0p = np.concatenate([u0, np.full(k_pad - k, 0.5 + 0.0j)])

        eager = jax.default_backend() == "cpu"

        def program(*planes):
            # Newton on the (forward or reversed) polynomial at u, both
            # with |u| <= 1: w = p/p' = u p / s (s = sum k c_k u^k)
            u = ((planes[0], planes[1]), (planes[2], planes[3]))
            for _ in range(iters):
                p, s = _cdf_horner_pair(cc, kk, u, use_scan=not eager)
                w = _cdf_div_guarded(cdf_mul(u, p), s)
                u = cdf_sub(u, w)
            p, _s = _cdf_horner_pair(cc, kk, u, use_scan=not eager)
            # Mosier denominator sum |c_k| |u|^k in f32 (a bound, not a
            # cancellation-prone value)
            au = jnp.sqrt((u[0][0] + u[0][1]) ** 2 + (u[1][0] + u[1][1]) ** 2)

            def dstep(acc, a_ck):
                return acc * au ** 64 + sum(
                    a_ck[j] * au ** j for j in range(64)), None

            nch = -(-int(deg + 1) // 64)
            a_pad = jnp.pad(abs_c, (0, nch * 64 - (deg + 1))).reshape(nch, 64)
            if eager:
                den = jnp.zeros_like(au)
                for i in range(nch):
                    den, _ = dstep(den, a_pad[::-1][i])
            else:
                den, _ = jax.lax.scan(dstep, jnp.zeros_like(au), a_pad[::-1])
            p_abs = jnp.sqrt((p[0][0] + p[0][1]) ** 2
                             + (p[1][0] + p[1][1]) ** 2)
            eta_ = p_abs / jnp.maximum(den, np.finfo(np.float32).tiny)
            return (u[0][0], u[0][1], u[1][0], u[1][1], eta_)

        re, im = np.real(u0p), np.imag(u0p)
        planes = []
        for v in (re, im):
            h = v.astype(np.float32)
            lo = (v - h.astype(np.float64)).astype(np.float32)
            planes += [jnp.asarray(h), jnp.asarray(lo)]
        runner = program if eager else jax.jit(program)
        outp = runner(planes[0], planes[1], planes[2], planes[3])
        u_ref = (np.asarray(outp[0], np.float64)
                 + np.asarray(outp[1], np.float64)
                 + 1j * (np.asarray(outp[2], np.float64)
                         + np.asarray(outp[3], np.float64)))[:k]
        e = np.asarray(outp[4], np.float64)[:k]
        return u_ref, e

    prepped = _prep(coeffs128)
    prepped_rev = _prep(coeffs128[::-1])
    if inside.any():
        zi, ei = _run(prepped, roots[inside])
        out[inside] = zi
        eta[inside] = ei
    if (~inside).any():
        uo, eo = _run(prepped_rev, 1.0 / roots[~inside])
        out[~inside] = 1.0 / uo
        eta[~inside] = eo
    return out, eta
