"""Batched polynomial rootfinding — the accelerator replacement for eiscor.

The reference locates all roots of (monodromy) polynomials with a Fortran
unitary-plus-rank-one companion QR (src/3rd_party/eiscor, entry
z_poly_roots_modified.f90:39-122, shim fnft__poly_roots_fasteigen.c:25-48).
A sequential QR iteration maps poorly to accelerators; instead we use the
Ehrlich–Aberth simultaneous all-root iteration:

    z_i <- z_i - w_i / (1 - w_i * sum_{j != i} 1/(z_i - z_j)),  w_i = p/p'

which is embarrassingly parallel across roots (O(deg^2) work per sweep on
the device) and converges cubically for simple roots. Initial guesses come
from the Newton polygon (upper convex hull of (k, log|c_k|)) following
Bini, "Numerical computation of polynomial zeros by means of Aberth's
method", Numer. Algorithms 13 (1996) — the standard robust initialization.

The polynomial evaluation inside the iteration is a *block Horner*: the
coefficient array is reshaped into [num_chunks, L] and contracted against a
Vandermonde block [L, K] as one matrix product, so the sequential depth is
deg/L instead of deg.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from fnft_tpu.config import complex_dtype_of, eps_of

_CHUNK = 64
# float32/complex64 products must not drop to TF32 on GPUs
_HIGHEST = jax.lax.Precision.HIGHEST


def _repulsion_chunked(z_all, z_t, t_idx, lowprec: bool = True):
    """Aberth repulsion ``s_i = sum_{j != t_idx_i} 1/(z_t_i - z_all_j)``.

    Chunked over ``j`` so the ``[m, chunk]`` distance block stays bounded
    (<= 2^26 elements) at eiscor's worst-case degrees (~1e5). With
    ``lowprec`` the reciprocal + row-sum run in complex64: the repulsion
    term only steers the iteration *path* — the fixed point (p(z)=0, where
    the Newton ratio w vanishes) is independent of s — so f32 precision
    here is accuracy-neutral while halving the dominant O(deg^2) sweep
    cost. Differences are formed in the full input precision first so tight
    root clusters do not cancel in f32.
    """
    deg = z_all.shape[0]
    m = z_t.shape[0]
    chunk = max(512, min(1 << 16, (1 << 26) // max(m, 1)))
    nch = -(-deg // chunk)
    zp = jnp.pad(z_all, (0, nch * chunk - deg))
    lo = jnp.complex64 if lowprec else z_all.dtype

    def body(c, acc):
        zc = jax.lax.dynamic_slice_in_dim(zp, c * chunk, chunk)
        jc = c * chunk + jnp.arange(chunk)
        diff = (z_t[:, None] - zc[None, :]).astype(lo)
        bad = (t_idx[:, None] == jc[None, :]) | (jc[None, :] >= deg)
        inv = jnp.where(bad, 0.0, 1.0 / jnp.where(bad, 1.0, diff))
        return acc + jnp.sum(inv, axis=1).astype(z_all.dtype)

    return jax.lax.fori_loop(0, nch, body, jnp.zeros_like(z_t))


def _block_eval_ratio(coeffs, z):
    """w = p(z)/p'(z), evaluated stably for |z| inside/outside the unit disk.

    Uses r(z) = p(z)/p'(z) = 1 / d/dz[log p(z)]. For |z| > 1 we evaluate the
    reversed polynomial q(u) = u^deg p(1/u) at u = 1/z:
        p'(z)/p(z) = deg/z - q'(u)/q(u) * u^2 ... simplified below.
    Overflow is avoided because only ratios are formed.
    """
    deg = coeffs.shape[-1] - 1
    kvec = jnp.arange(deg + 1, dtype=jnp.real(coeffs).dtype)

    inside = jnp.abs(z) <= 1.0
    u = jnp.where(inside, z, 1.0 / jnp.where(z == 0, 1.0, z))

    def eval_pair(cs, x):
        """(p(x), s(x)) with s = sum k c_k x^k, block-Horner on chunks."""
        n = cs.shape[-1]
        nch = -(-n // _CHUNK)
        pad = nch * _CHUNK - n
        cs_p = jnp.pad(cs, (0, pad)).reshape(nch, _CHUNK)
        ks_p = jnp.pad(cs * kvec[:n], (0, pad)).reshape(nch, _CHUNK)
        # Vandermonde block x^j for j < CHUNK: [CHUNK, K]
        xp = jnp.cumprod(jnp.concatenate([jnp.ones_like(x)[None],
                                          jnp.tile(x[None], (_CHUNK - 1, 1))], 0), axis=0)
        inner_p = jnp.matmul(cs_p, xp, precision=_HIGHEST)   # [nch, K]
        inner_s = jnp.matmul(ks_p, xp, precision=_HIGHEST)
        x_l = xp[-1] * x      # x^CHUNK

        def step(carry, inners):
            accp, accs = carry
            ip, is_ = inners
            return (accp * x_l + ip, accs * x_l + is_), None

        (pv, sv), _ = jax.lax.scan(
            step,
            (jnp.zeros_like(x), jnp.zeros_like(x)),
            (inner_p[::-1], inner_s[::-1]),
        )
        return pv, sv

    p_in, s_in = eval_pair(coeffs, u)           # for |z| <= 1
    p_rev, s_rev = eval_pair(coeffs[::-1], u)   # q(u), sum k q_k u^k

    # inside: p'/p = s_in / (z * p_in)
    safe_pin = jnp.where(p_in == 0, 1.0, p_in)
    lg_in = s_in / (u * safe_pin)
    # outside: p(z) = z^deg q(u);  p'/p = (deg - s_rev/q) / z = u*(deg - s_rev/q)
    safe_prev = jnp.where(p_rev == 0, 1.0, p_rev)
    lg_out = u * (deg - s_rev / safe_prev)
    log_deriv = jnp.where(inside, lg_in, lg_out)

    p_is_zero = jnp.where(inside, p_in == 0, p_rev == 0)
    w = 1.0 / jnp.where(log_deriv == 0, 1.0, log_deriv)
    w = jnp.where(p_is_zero, 0.0, w)  # exactly at a root: no update
    return w


def _newton_polygon_init(abs_coeffs: np.ndarray) -> np.ndarray:
    """Bini initial guesses from the upper convex hull of (k, log|c_k|)."""
    n = len(abs_coeffs) - 1
    with np.errstate(divide="ignore"):
        logc = np.where(abs_coeffs > 0, np.log(np.where(abs_coeffs > 0,
                                                        abs_coeffs, 1.0)), -np.inf)
    # upper convex hull via monotone chain over indices with finite logc
    idx = [k for k in range(n + 1) if np.isfinite(logc[k])]
    if len(idx) < 2:  # degenerate polynomial; fall back to unit circle
        ang = 2 * np.pi * (np.arange(n) + 0.5) / max(n, 1) + 0.3
        return np.exp(1j * ang)
    hull: list[int] = []
    for k in idx:
        while len(hull) >= 2:
            i, j = hull[-2], hull[-1]
            # keep hull upper-convex: drop j if it lies below segment (i, k)
            if (logc[j] - logc[i]) * (k - i) <= (logc[k] - logc[i]) * (j - i):
                hull.pop()
            else:
                break
        hull.append(k)
    guesses = np.zeros(n, dtype=np.complex128)
    pos = 0
    # roots "at infinity" for leading zero coefficients: big circle
    if hull[-1] < n:
        m = n - hull[-1]
        big = 1e6
        ang = 2 * np.pi * (np.arange(m) + 0.5) / m
        guesses[pos: pos + m] = big * np.exp(1j * ang)
        pos += m
    # roots at ~0 for trailing zero coefficients
    if hull[0] > 0:
        m = hull[0]
        ang = 2 * np.pi * (np.arange(m) + 0.5) / m
        guesses[pos: pos + m] = 1e-6 * np.exp(1j * ang)
        pos += m
    sigma = 0.7  # fixed rotation offset decorrelating circles (Bini sec. 5)
    for a, b in zip(hull[:-1], hull[1:]):
        m = b - a
        r = (abs_coeffs[a] / abs_coeffs[b]) ** (1.0 / m)
        r = min(max(r, 1e-12), 1e12)
        ang = 2 * np.pi * (np.arange(m) + 0.5) / m + sigma * b
        guesses[pos: pos + m] = r * np.exp(1j * ang)
        pos += m
    return guesses[:n]


def newton_polygon_init_jax(coeffs):
    """Traceable Newton-polygon initial guesses (Bini) for ``coeffs``.

    Builds the upper convex hull of (k, log|c_k|) with a lax.scan (stack in
    a fixed-size array), then places roots on the per-segment circles. All
    shapes static: returns ``[deg]`` initial points. Vmappable, so batched
    pipelines get polygon-quality starts without host syncs.
    """
    coeffs = jnp.asarray(coeffs)
    radius, ang = newton_polygon_polar_jax(jnp.abs(coeffs))
    return (radius * jnp.exp(1j * ang)).astype(complex_dtype_of(coeffs))


def newton_polygon_polar_jax(absc):
    """Traceable Bini initial guesses as (radius, angle) real arrays.

    The polar split lets complex-free backends (ops/tpu_roots.py) build
    the same initial points without any complex-typed HLO."""
    absc = jnp.asarray(absc)
    n1 = absc.shape[-1]
    deg = n1 - 1
    rdt = absc.dtype
    neg_inf = jnp.asarray(-jnp.inf, rdt)
    logc = jnp.where(absc > 0, jnp.log(jnp.where(absc > 0, absc, 1.0)),
                     neg_inf)

    # Andrew monotone chain (upper hull) over valid points
    def push(carry, k):
        stack, size = carry  # stack: int32[n1], size: int32
        valid = jnp.isfinite(logc[k])

        def pop_cond(state):
            st, sz = state
            i = st[jnp.maximum(sz - 2, 0)]
            j = st[jnp.maximum(sz - 1, 0)]
            drop = (logc[j] - logc[i]) * (k - i).astype(rdt) <= \
                (logc[k] - logc[i]) * (j - i).astype(rdt)
            return (sz >= 2) & drop

        def pop_body(state):
            st, sz = state
            return st, sz - 1

        stack, size = jax.lax.cond(
            valid,
            lambda s: jax.lax.while_loop(pop_cond, pop_body, s),
            lambda s: s, (stack, size))
        stack = jnp.where(valid, stack.at[size].set(k), stack)
        size = jnp.where(valid, size + 1, size)
        return (stack, size), None

    stack0 = jnp.zeros((n1,), jnp.int32)
    (stack, size), _ = jax.lax.scan(push, (stack0, jnp.int32(0)),
                                    jnp.arange(n1, dtype=jnp.int32))

    # per-coefficient segment assignment: root slot r (0..deg-1) belongs to
    # hull segment (stack[s], stack[s+1]) covering ks in [stack[s], stack[s+1})
    seg_start = stack                                  # [n1]
    seg_end = jnp.roll(stack, -1)                      # [n1]
    seg_valid = jnp.arange(n1) < (size - 1)
    # radius per segment
    a_idx, b_idx = seg_start, seg_end
    safe_m = jnp.maximum((b_idx - a_idx).astype(rdt), 1.0)
    r_seg = jnp.exp((logc[a_idx] - logc[b_idx]) / safe_m)
    r_seg = jnp.clip(jnp.where(seg_valid, r_seg, 1.0), 1e-12, 1e12)

    # map each root slot to its segment via searchsorted on seg_start
    slots = jnp.arange(deg)
    first = stack[0]
    pos = jnp.clip(slots + first, 0, n1 - 1)   # roots indexed from the first hull vertex
    starts = jnp.where(seg_valid, seg_start, n1 + 1)
    seg_of = jnp.clip(jnp.searchsorted(starts, pos, side="right") - 1, 0,
                      n1 - 1)
    radius = r_seg[seg_of]
    m_seg = jnp.maximum(seg_end[seg_of] - seg_start[seg_of], 1).astype(rdt)
    j_in = (pos - seg_start[seg_of]).astype(rdt)
    two_pi = 6.283185307179586
    ang = two_pi * (j_in + 0.5) / m_seg + 0.7 * seg_end[seg_of].astype(rdt)
    return radius, ang


@partial(jax.jit, static_argnames=("num_iters", "return_iters"))
def aberth_roots(coeffs, z0, num_iters: int = 80,
                 return_iters: bool = False):
    """Run Ehrlich–Aberth sweeps from initial guesses ``z0``.

    Args:
      coeffs: ascending coefficients ``[deg+1]`` (complex).
      z0: initial guesses ``[deg]``.
      num_iters: maximum sweeps (early exit on convergence).
      return_iters: also return the executed sweep count (int32 scalar).

    Returns roots ``[deg]`` (and the sweep count when ``return_iters``).
    """
    coeffs = jnp.asarray(coeffs)
    cdt = complex_dtype_of(coeffs)
    coeffs = coeffs.astype(cdt)
    z0 = jnp.asarray(z0).astype(cdt)
    deg = coeffs.shape[-1] - 1
    tol = 100.0 * eps_of(cdt)

    def _pairwise_sum(z):
        """sum_{j != i} 1/(z_i - z_j); dense (c128) below 4096 roots,
        chunked complex64 above (see :func:`_repulsion_chunked` for why
        low precision is safe and how memory stays bounded at deg ~1e5)."""
        if deg <= 4096:
            eye = jnp.eye(deg, dtype=bool)
            diff = z[:, None] - z[None, :]
            inv = jnp.where(eye, 0.0, 1.0 / jnp.where(eye, 1.0, diff))
            return jnp.sum(inv, axis=1)
        return _repulsion_chunked(z, z, jnp.arange(deg))

    rdt = jnp.real(z0).dtype

    def sweep(state):
        z, frozen, _, it = state
        w = _block_eval_ratio(coeffs, z)
        s = _pairwise_sum(z)
        denom = 1.0 - w * s
        corr = w / jnp.where(denom == 0, 1.0, denom)
        z_new = jnp.where(frozen, z, z - corr)
        rel = jnp.abs(corr) / jnp.maximum(jnp.abs(z_new), 1e-30)
        # freeze converged roots: they stop moving but keep repelling the
        # others through the pairwise sum (cluster stability at deg ~1e4+)
        frozen = frozen | (rel < tol)
        moved = jnp.max(jnp.where(frozen, 0.0, rel))
        return z_new, frozen, moved, it + 1

    def cond(state):
        _, _, moved, it = state
        return (moved > tol) & (it < num_iters)

    def run(z_init, frozen_init, iters):
        return jax.lax.while_loop(
            cond, sweep,
            (z_init, frozen_init, jnp.asarray(jnp.inf, rdt), iters))

    z, frozen, _, it = run(z0, jnp.zeros(deg, dtype=bool), 0)

    # stagnation restart (eiscor analogue: deflation restarts). Roots still
    # moving after the budget are nudged off the stagnation cycle by a
    # deterministic per-root phase kick and given the remaining sweeps.
    def restart(args):
        z_, frozen_, it_ = args
        kick = 1.0 + 64.0 * tol * jnp.cos(
            jnp.arange(deg, dtype=rdt) * 2.399963229728653)  # golden angle
        z_k = jnp.where(frozen_, z_, z_ * kick.astype(z_.dtype))
        z2, _, _, it2 = run(z_k, frozen_, num_iters // 2)
        # restart resumes the sweep counter at num_iters//2; report total
        # executed sweeps = it (first phase) + (it2 - num_iters//2)
        return z2, it_ + (it2 - num_iters // 2)

    z, it = jax.lax.cond(jnp.all(frozen), lambda a: (a[0], a[2]), restart,
                         (z, frozen, it))
    if return_iters:
        return z, it
    return z


@partial(jax.jit, static_argnames=("k",))
def _sweep_block(coeffs, z, frozen, k: int):
    """Up to ``k`` full Ehrlich-Aberth sweeps (early exit on convergence).

    One jitted stage of the host-staged driver. Returns
    ``(z, frozen, moved, n_done)``.
    """
    coeffs = jnp.asarray(coeffs)
    cdt = complex_dtype_of(coeffs)
    deg = coeffs.shape[-1] - 1
    tol = 100.0 * eps_of(cdt)
    rdt = jnp.real(z).dtype
    idx = jnp.arange(deg)

    def sweep(state):
        z, frozen, _, n = state
        w = _block_eval_ratio(coeffs, z)
        s = _repulsion_chunked(z, z, idx)
        denom = 1.0 - w * s
        corr = w / jnp.where(denom == 0, 1.0, denom)
        z_new = jnp.where(frozen, z, z - corr)
        rel = jnp.abs(corr) / jnp.maximum(jnp.abs(z_new), 1e-30)
        frozen = frozen | (rel < tol)
        moved = jnp.max(jnp.where(frozen, 0.0, rel))
        return z_new, frozen, moved, n + 1

    def cond(state):
        _, _, moved, n = state
        return (moved > tol) & (n < k)

    return jax.lax.while_loop(
        cond, sweep, (z, frozen, jnp.asarray(jnp.inf, rdt), jnp.int32(0)))


@partial(jax.jit, static_argnames=("k",))
def _polish_block(coeffs, z_full, idx, valid, k: int):
    """Up to ``k`` active-set Aberth sweeps on the roots ``z_full[idx]``.

    The deflation stage: only the (padded, static-``cap``) active tail
    iterates — evaluation and repulsion cost O(cap * deg) per sweep
    instead of O(deg^2) — while every root, frozen or not, keeps
    repelling through the current ``z_full``. Padding entries of ``idx``
    (marked ``valid=False``) hold the out-of-range index ``deg``: their
    scatter updates are dropped by XLA and they are frozen from sweep
    one, so they never touch real roots. (In-range duplicate padding
    would race real updates in the scatter — do not use it.)

    Returns ``(z_full, frozen_active, moved, n_done)``.
    """
    coeffs = jnp.asarray(coeffs)
    cdt = complex_dtype_of(coeffs)
    tol = 100.0 * eps_of(cdt)
    rdt = jnp.real(z_full).dtype

    def sweep(state):
        z_full, za, frozen_a, _, n = state
        w = _block_eval_ratio(coeffs, za)
        s = _repulsion_chunked(z_full, za, idx)
        denom = 1.0 - w * s
        corr = w / jnp.where(denom == 0, 1.0, denom)
        za_new = jnp.where(frozen_a, za, za - corr)
        rel = jnp.abs(corr) / jnp.maximum(jnp.abs(za_new), 1e-30)
        frozen_a = frozen_a | (rel < tol) | ~valid
        moved = jnp.max(jnp.where(frozen_a, 0.0, rel))
        z_full = z_full.at[idx].set(za_new)  # OOB padding rows drop
        return z_full, za_new, frozen_a, moved, n + 1

    def cond(state):
        _, _, _, moved, n = state
        return (moved > tol) & (n < k)

    z_full, za, frozen_a, moved, n = jax.lax.while_loop(
        cond, sweep,
        (z_full, z_full[idx], jnp.zeros(idx.shape[0], bool),
         jnp.asarray(jnp.inf, rdt), jnp.int32(0)))
    return z_full, frozen_a, moved, n


def aberth_roots_deflated(coeffs, z0, num_iters: int = 80, block: int = 3,
                          deflate_frac: float = 0.5, min_cap: int = 256,
                          return_iters: bool = False):
    """Host-staged Ehrlich-Aberth with active-set deflation.

    eiscor deflates converged roots out of its QR iteration
    (src/3rd_party/eiscor/z_poly_roots_modified.f90:39-122); this is the
    batched analogue for the large-degree regime (nsep monodromy reaches
    deg = 105*Dsub ~ 1e5, src/fnft_nsep.c:534-556). Full sweeps run in
    jitted blocks of ``block`` until at most ``deflate_frac`` of the
    roots are still moving; after that only the unfrozen tail iterates
    (:func:`_polish_block`), at O(cap * deg) per sweep with the active
    capacity re-bucketed (powers of two) every ``block`` sweeps as the
    tail shrinks. In the measured SPLIT7A monodromy family the frozen
    fraction goes 61% -> 80% -> 89% -> 95% over sweeps 7-10 (of ~17), so
    tracking the knee removes most of the O(deg^2) tail cost.

    Semantics match :func:`aberth_roots` (same tolerance, freeze rule and
    golden-angle stagnation kick); iteration budget ``num_iters`` may be
    overshot by at most ``block - 1`` sweeps per stage boundary. The
    host-side stage loop makes this function non-traceable — inside jit
    use :func:`aberth_roots`.
    """
    coeffs = jnp.asarray(coeffs)
    cdt = complex_dtype_of(coeffs)
    coeffs = coeffs.astype(cdt)
    z = jnp.asarray(z0).astype(cdt)
    deg = coeffs.shape[-1] - 1
    tol = 100.0 * eps_of(cdt)

    def _polish_until(z, frozen_np, budget, it):
        """Active-set stages until convergence or ``budget`` sweeps."""
        done = 0
        while done < budget:
            idx_np = np.nonzero(~frozen_np)[0]
            na = idx_np.size
            if na == 0:
                break
            cap = max(min_cap, 1 << int(na - 1).bit_length())
            if cap >= deg:
                # tail not small enough for a gather win: full sweeps
                frozen_j = jnp.asarray(frozen_np)
                z, frozen_j, moved, n = _sweep_block(
                    coeffs, z, frozen_j, block)
                done += int(n)
                it += int(n)
                # .copy(): np.asarray of a jax array is a read-only view
                frozen_np = np.asarray(frozen_j).copy()
                if float(moved) <= tol:
                    frozen_np[:] = True
                    break
                continue
            idx_pad = np.full(cap, deg, np.int32)  # OOB: dropped scatters
            idx_pad[:na] = idx_np
            valid = np.zeros(cap, bool)
            valid[:na] = True
            z, frozen_a, moved, n = _polish_block(
                coeffs, z, jnp.asarray(idx_pad), jnp.asarray(valid), block)
            done += int(n)
            it += int(n)
            frozen_np = frozen_np.copy()
            frozen_np[idx_np] = np.asarray(frozen_a)[:na]
            if float(moved) <= tol:
                frozen_np[idx_np] = True
                break
        return z, frozen_np, it

    frozen = jnp.zeros(deg, bool)
    it = 0
    converged = False
    while it < num_iters:
        z, frozen, moved, n = _sweep_block(coeffs, z, frozen, block)
        it += int(n)
        if float(moved) <= tol:
            converged = True
            break
        frozen_np = np.asarray(frozen)
        if (~frozen_np).sum() <= deflate_frac * deg:
            z, frozen_np, it = _polish_until(
                z, frozen_np, num_iters - it, it)
            converged = bool(frozen_np.all())
            frozen = jnp.asarray(frozen_np)
            break

    # stagnation kick (cf. aberth_roots): nudge survivors off any cycle
    # and grant num_iters // 2 extra polish sweeps.
    frozen_np = np.asarray(frozen)
    if not converged and not frozen_np.all():
        idx_np = np.nonzero(~frozen_np)[0]
        kick = 1.0 + 64.0 * tol * np.cos(idx_np * 2.399963229728653)
        # post-promotion dtype (z0 may be c64 while z was promoted to c128;
        # in f32 the ~1e-12 kick would round to exactly 1.0 — a no-op)
        z = z.at[idx_np].multiply(kick.astype(jnp.real(z).dtype))
        z, frozen_np, it = _polish_until(z, frozen_np, num_iters // 2, it)
    if return_iters:
        return z, it
    return z


@jax.jit
def root_residuals(coeffs, z):
    """Per-root relative backward error ``eta_i`` of ``z`` w.r.t. ``coeffs``.

    ``eta_i = |p(z_i)| / sum_k |c_k| |z_i|^k`` is the smallest relative
    coefficient-wise perturbation making ``z_i`` an exact root (Mosier's
    bound); eiscor is backward stable by construction, so certified Aberth
    roots (``eta <= ~deg * eps``) match its contract. For ``|z| > 1`` the
    reversed polynomial is used so nothing overflows.

    Returns ``eta`` with the same shape as ``z`` (real dtype).
    """
    coeffs = jnp.asarray(coeffs)
    cdt = complex_dtype_of(coeffs)
    coeffs = coeffs.astype(cdt)
    z = jnp.asarray(z).astype(cdt)
    rdt = jnp.real(coeffs).dtype
    deg = coeffs.shape[-1] - 1

    inside = jnp.abs(z) <= 1.0
    u = jnp.where(inside, z, 1.0 / jnp.where(z == 0, 1.0, z))
    au = jnp.abs(u)

    def eval_abs_pair(cs, x, ax):
        """(p(x), sum_k |c_k| ax^k) block-Horner (cf. _block_eval_ratio)."""
        n = cs.shape[-1]
        nch = -(-n // _CHUNK)
        pad = nch * _CHUNK - n
        cs_p = jnp.pad(cs, (0, pad)).reshape(nch, _CHUNK)
        ab_p = jnp.pad(jnp.abs(cs), (0, pad)).reshape(nch, _CHUNK)
        xp = jnp.cumprod(jnp.concatenate(
            [jnp.ones_like(x)[None], jnp.tile(x[None], (_CHUNK - 1, 1))], 0),
            axis=0)
        axp = jnp.cumprod(jnp.concatenate(
            [jnp.ones_like(ax)[None], jnp.tile(ax[None], (_CHUNK - 1, 1))], 0),
            axis=0)
        inner_p = jnp.matmul(cs_p, xp, precision=_HIGHEST)
        inner_a = jnp.matmul(ab_p, axp, precision=_HIGHEST)
        x_l = xp[-1] * x
        ax_l = axp[-1] * ax

        def step(carry, inners):
            accp, acca = carry
            ip, ia = inners
            return (accp * x_l + ip, acca * ax_l + ia), None

        (pv, av), _ = jax.lax.scan(
            step, (jnp.zeros_like(x), jnp.zeros_like(ax)),
            (inner_p[::-1], inner_a[::-1]))
        return pv, av

    p_in, a_in = eval_abs_pair(coeffs, u, au)
    p_rev, a_rev = eval_abs_pair(coeffs[::-1], u, au)
    pv = jnp.where(inside, jnp.abs(p_in), jnp.abs(p_rev))
    av = jnp.where(inside, a_in, a_rev)
    # tiny of the *working* real dtype: float64's tiny underflows to 0 in
    # float32, which would turn the guard into 0/0 = NaN at exact roots of
    # polynomials with zero constant coefficient
    return (pv / jnp.maximum(av, jnp.asarray(np.finfo(np.dtype(rdt)).tiny,
                                             rdt))).astype(rdt)


def certified_tol(deg: int, dtype=np.complex128) -> float:
    """Default acceptance threshold for :func:`root_residuals`: a backward
    error of O(deg * eps) is what a backward-stable method (eiscor)
    guarantees; the 64x headroom absorbs Aberth's final-sweep noise."""
    return 64.0 * max(deg, 1) * float(eps_of(np.dtype(dtype)))


def poly_roots(coeffs, num_iters: int = 80, init: str = "auto",
               return_residuals: bool = False):
    """All roots of a polynomial via Ehrlich-Aberth sweeps on device.

    Drop-in for the reference's poly_roots_fasteigen (eiscor). Initial
    guesses come from the Newton polygon; ``init`` selects where the
    polygon is built:

    * ``"device"`` — the traced hull (:func:`newton_polygon_init_jax`)
      fuses into the same XLA program as the sweeps, so accelerator
      pipelines run without a host round-trip per polynomial.
    * ``"host"`` — concrete coefficient magnitudes on the host (native
      C++ hull when built). A CPU fast path: the hull is O(deg) scalar
      work that a host core does quicker than a lax.scan.
    * ``"auto"`` (default) — ``"host"`` when the default backend is CPU,
      ``"device"`` otherwise.

    With ``return_residuals=True`` also returns the per-root relative
    backward error from :func:`root_residuals` (certificate contract:
    accept roots with ``eta <= certified_tol(deg)``).
    """
    coeffs = jnp.asarray(coeffs)
    traced = isinstance(coeffs, jax.core.Tracer)
    if init == "auto":
        init = "host" if (jax.default_backend() == "cpu" and not traced) \
            else "device"
    if init == "device":
        z0 = newton_polygon_init_jax(coeffs)
    else:
        abs_c = np.abs(np.asarray(jax.device_get(coeffs), dtype=np.complex128))
        try:
            from fnft_tpu.native import newton_polygon_init as _init
            z0 = jnp.asarray(_init(abs_c))
        except Exception:
            z0 = jnp.asarray(_newton_polygon_init(abs_c))
    if coeffs.shape[-1] - 1 > 16384 and not traced:
        # eiscor's large-degree regime: host-staged active-set deflation
        roots = aberth_roots_deflated(coeffs, z0, num_iters=num_iters)
    else:
        roots = aberth_roots(coeffs, z0, num_iters=num_iters)
    if return_residuals:
        return roots, root_residuals(coeffs, roots)
    return roots


@partial(jax.jit, static_argnames=("num_iters",))
def poly_roots_batched(coeffs, num_iters: int = 80):
    """Roots of a batch of same-degree polynomials ``[B, deg+1] -> [B, deg]``.

    One XLA program: vmapped traced Newton-polygon init + Aberth sweeps.
    Replaces per-polynomial :func:`poly_roots` loops (e.g. the reference's
    per-spine eiscor calls in fnft_nsep.c:556-608) with a single device
    dispatch.
    """
    coeffs = jnp.asarray(coeffs)

    def one(c):
        return aberth_roots(c, newton_polygon_init_jax(c),
                            num_iters=num_iters)

    return jax.vmap(one)(coeffs)
