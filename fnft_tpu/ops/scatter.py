"""Slow (ODE-style) AKNS scattering as lax.scan over 2x2 matrix products.

Rebuild of fnft__akns_scatter_matrix.c (monodromy with optional
lambda-derivative) and fnft__nse_scatter_bound_states.c (phi/psi sweeps for
a, a', b at bound states). The D-axis recurrence is inherently sequential;
each step is vectorized over the whole spectral grid (K lambdas), so the
scan body is elementwise work of width K.

Derivatives are tracked with the pair recurrence (T, T') -> (U T, U' T + U T')
instead of the reference's augmented 4x4 blocks — same math, half the FLOPs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from fnft_tpu.config import complex_dtype_of
from fnft_tpu.models.discretization import (
    BOUNDARY_COEFF,
    Discretization,
    lambda_stage_weights,
    upsampling_factor,
)

_CF_FAMILY = (Discretization.BO, Discretization.CF4_2, Discretization.CF4_3,
              Discretization.CF5_3, Discretization.CF6_4,
              Discretization.SPLIT4A4, Discretization.SPLIT4B4)


def _stage_weight_per_step(disc: Discretization, d_eff: int, dtype):
    """Per-step lambda scaling: stage weights tiled over the sample axis."""
    w = lambda_stage_weights(disc)
    reps = d_eff // len(w)
    return jnp.asarray(np.tile(w, reps), dtype=dtype)


def _cf_step_matrices(qn, rn, l, eps_t, *, derivative: bool):
    """One CF-family step: U (and dU/dlam) for a vector of lambdas.

    U = [[ch - i l sh, q sh], [r sh, ch + i l sh]] with k = sqrt(qr - l^2),
    ch = cosh(k eps), sh = sinh(k eps)/k (reference scatter_matrix.c:172-233).
    All ks -> 0 singularities are removed via series limits.
    """
    ks = qn * rn - l * l
    k = jnp.sqrt(ks)
    ch = jnp.cosh(k * eps_t)
    small = jnp.abs(ks) < 1e-30
    ks_safe = jnp.where(small, 1.0, ks)
    sh = jnp.where(small, eps_t, jnp.sinh(k * eps_t) / jnp.where(small, 1.0, k))
    u1 = 1j * l * sh
    U = jnp.stack([
        jnp.stack([ch - u1, qn * sh], axis=-1),
        jnp.stack([rn * sh, ch + u1], axis=-1),
    ], axis=-2)
    if not derivative:
        return U, None
    # g = (eps ch - sh)/ks, series limit eps^3/3 as ks -> 0
    g = jnp.where(small, (eps_t ** 3) / 3.0, (eps_t * ch - sh) / ks_safe)
    du00 = 1j * l * l * g - (l * eps_t + 1j) * sh
    du11 = -1j * l * l * g - (l * eps_t - 1j) * sh
    dU = jnp.stack([
        jnp.stack([du00, -qn * l * g], axis=-1),
        jnp.stack([-rn * l * g, du11], axis=-1),
    ], axis=-2)
    return U, dU


def _pauli_exp(a1, a2, a3):
    """expm(i w n.sigma)-style closed form used by ES4/TES4:
    U = c I + s [a3, a1 - i a2; a1 + i a2, -a3], w = sqrt(-a1^2-a2^2-a3^2)."""
    w = jnp.sqrt(-(a1 * a1) - (a2 * a2) - (a3 * a3))
    small = jnp.abs(w) < 1e-30
    s = jnp.where(small, 1.0, jnp.sin(w) / jnp.where(small, 1.0, w))
    c = jnp.cos(w)
    U = jnp.stack([
        jnp.stack([c + s * a3, s * (a1 - 1j * a2)], axis=-1),
        jnp.stack([s * (a1 + 1j * a2), c - s * a3], axis=-1),
    ], axis=-2)
    return U, w, s, c


def _es4_coeffs(q3, r3, eps_t):
    """Sample-triplet [q, q', q''] -> Pauli coefficients (scatter_matrix.c:266-269)."""
    e3 = eps_t ** 3
    t0 = e3 * (q3[..., 2] + r3[..., 2]) / 48.0 + eps_t * (q3[..., 0] + r3[..., 0]) * 0.5
    t1 = (eps_t * (q3[..., 0] - r3[..., 0]) * 1j) * 0.5 + (e3 * (q3[..., 2] - r3[..., 2]) * 1j) / 48.0
    t2 = -e3 * (q3[..., 0] * r3[..., 1] - q3[..., 1] * r3[..., 0]) / 12.0
    return t0, t1, t2


def _es4_step(q3, r3, l, eps_t, *, derivative: bool, backward: bool = False):
    e3 = eps_t ** 3
    t0, t1, t2 = _es4_coeffs(q3, r3, eps_t)
    a1 = t0 + e3 * (l * 1j * (q3[..., 1] - r3[..., 1])) / 12.0
    a2 = t1 - e3 * l * (q3[..., 1] + r3[..., 1]) / 12.0
    a3 = -eps_t * 1j * l + t2
    if backward:
        a1, a2, a3 = -a1, -a2, -a3
    U, w, s, c = _pauli_exp(a1, a2, a3)
    if not derivative:
        return U, None
    # derivatives of (a1,a2,a3) w.r.t. lambda (sign flips with backward)
    d1 = 1j * e3 * (q3[..., 1] - r3[..., 1]) / 12.0
    d2 = -e3 * (q3[..., 1] + r3[..., 1]) / 12.0
    d3 = -1j * eps_t * jnp.ones_like(a3)
    if backward:
        d1, d2, d3 = -d1, -d2, -d3
    w_safe = jnp.where(w == 0, 1.0, w)
    w_d = -(a1 * d1 + a2 * d2 + a3 * d3) / w_safe
    c_d = -jnp.sin(w) * w_d
    s_d = w_d * (c - s) / w_safe
    dU = jnp.stack([
        jnp.stack([c_d + s_d * a3 + s * d3,
                   s_d * a1 + s * d1 - 1j * (s_d * a2 + s * d2)], axis=-1),
        jnp.stack([s_d * a1 + s * d1 + 1j * (s_d * a2 + s * d2),
                   c_d - s_d * a3 - s * d3], axis=-1),
    ], axis=-2)
    return U, dU


def _tes4_outer_coeffs(q3, r3, eps_t, *, backward: bool):
    """TES4 first/third factors (scatter_matrix.c:298-303, bound_states :165-183)."""
    e3, e2 = eps_t ** 3, eps_t ** 2
    sgn = -1.0 if backward else 1.0
    t1a = sgn * e3 * (q3[..., 2] + r3[..., 2]) / 96.0 - e2 * (q3[..., 1] + r3[..., 1]) / 24.0
    t1b = sgn * e3 * (q3[..., 2] - r3[..., 2]) * 1j / 96.0 + e2 * (r3[..., 1] - q3[..., 1]) * 1j / 24.0
    t2a = sgn * e3 * (q3[..., 2] + r3[..., 2]) / 96.0 + e2 * (q3[..., 1] + r3[..., 1]) / 24.0
    t2b = sgn * e3 * (q3[..., 2] - r3[..., 2]) * 1j / 96.0 + e2 * (q3[..., 1] - r3[..., 1]) * 1j / 24.0
    return (t1a, t1b), (t2a, t2b)


def _tes4_step(q3, r3, l, eps_t, *, derivative: bool, backward: bool = False):
    """TES4: product of three Pauli exponentials per step; only the middle
    factor depends on lambda (scatter_matrix.c:356-437)."""
    h = -eps_t if backward else eps_t
    (t1a, t1b), (t2a, t2b) = _tes4_outer_coeffs(q3, r3, eps_t, backward=backward)
    F1, _, _, _ = _pauli_exp(t1a, t1b, jnp.zeros_like(t1a))
    a1 = h * (q3[..., 0] + r3[..., 0]) * 0.5
    a2 = h * (q3[..., 0] * 1j - r3[..., 0] * 1j) * 0.5
    a3 = -h * l * 1j
    M, w, s, c = _pauli_exp(a1, a2, a3)
    F3, _, _, _ = _pauli_exp(t2a, t2b, jnp.zeros_like(t2a))
    U = F3 @ M @ F1
    if not derivative:
        return U, None
    # middle-factor derivative, reference scatter_matrix.c:391-397
    w_safe = jnp.where(w == 0, 1.0, w)
    s_d = jnp.sin(w * eps_t) / w_safe
    c_d = -eps_t * l * s_d
    w_d = l * (eps_t * w * jnp.cos(w * eps_t) - jnp.sin(w * eps_t)) / (w_safe ** 3)
    dM = jnp.stack([
        jnp.stack([c_d - 1j * s_d, w_d * q3[..., 0]], axis=-1),
        jnp.stack([w_d * r3[..., 0], c_d + 1j * s_d], axis=-1),
    ], axis=-2)
    dU = F3 @ dM @ F1
    return U, dU


def _family_inputs(q, r, eps_t, disc):
    """(xs pytree for scan, step_fn, derivative scale)."""
    cdt = complex_dtype_of(q)
    if disc in _CF_FAMILY:
        d_eff = q.shape[-1]
        wsteps = _stage_weight_per_step(disc, d_eff, cdt)
        scl = 1.0 / len(lambda_stage_weights(disc))

        def step(lam, qn, rn, wn, *, derivative, backward=False):
            h = -eps_t if backward else eps_t
            return _cf_step_matrices(qn, rn, lam * wn, h, derivative=derivative)

        xs = (q, r, wsteps)
        return xs, step, scl
    if disc in (Discretization.ES4, Discretization.TES4):
        d_eff = q.shape[-1]
        q3 = q.reshape(q.shape[:-1] + (d_eff // 3, 3))
        r3 = r.reshape(r.shape[:-1] + (d_eff // 3, 3))
        inner = _es4_step if disc is Discretization.ES4 else _tes4_step

        def step(lam, q3n, r3n, _unused, *, derivative, backward=False):
            return inner(q3n, r3n, lam, eps_t, derivative=derivative,
                         backward=backward)

        xs = (q3, r3, jnp.zeros(d_eff // 3, dtype=cdt))
        return xs, step, 1.0
    raise ValueError(f"{disc} is not a slow discretization")


def _use_log_depth() -> bool:
    """Tree/associative products on accelerators; sequential scans on CPU.

    Same math either way — on an accelerator a D-step sequential recurrence costs
    ~O(D) loop iterations of tiny work (latency-bound), while log-depth
    batched matmuls use the hardware; on the (single-core) CPU the scan
    avoids materializing every step matrix.
    """
    return jax.default_backend() != "cpu"


def _all_step_matrices(xs, step_fn, lam, derivative: bool):
    """All per-step matrices at once: U[S, K, 2, 2] (and dU or None)."""
    def one(x):
        u, du = step_fn(lam, x[0], x[1], x[2], derivative=derivative)
        return u, (du if derivative else jnp.zeros(()))

    u, du = jax.vmap(one)(xs)
    return u, (du if derivative else None)


def _pair_combine(a, b):
    """Associative combine for (T, T') with later blocks on the left:
    (AB = B @ A, (AB)' = B' A + B A')."""
    am, ad = a
    bm, bd = b
    m = bm @ am
    d = bd @ am + bm @ ad
    return m, d


def _tree_product(u, du):
    """Log-depth product U[S-1] ... U[0] (+ derivative), padding with
    identities. On an accelerator this turns the O(S) sequential recurrence into
    log2(S) batched matmul levels."""
    s = u.shape[0]
    cdt = u.dtype
    if du is None:
        du = jnp.zeros_like(u)
    import math as _math

    s_pad = 1 << max(0, (s - 1)).bit_length()
    if s_pad != s:
        eye = jnp.broadcast_to(jnp.eye(2, dtype=cdt), (s_pad - s,) + u.shape[1:])
        u = jnp.concatenate([u, eye], axis=0)
        du = jnp.concatenate([du, jnp.zeros_like(eye)], axis=0)
    levels = int(_math.log2(s_pad)) if s_pad > 1 else 0
    for _ in range(levels):
        a = (u[0::2], du[0::2])   # earlier
        b = (u[1::2], du[1::2])   # later
        u, du = _pair_combine(a, b)
    return u[0], du[0]


@partial(jax.jit, static_argnames=("eps_t", "disc", "derivative"))
def scatter_matrix(q, r, lam, eps_t: float, disc: Discretization,
                   *, derivative: bool = False):
    """Full-interval scattering matrix at each lambda.

    Args:
      q, r: effective-sample potentials ``[D_eff]``.
      lam: spectral points ``[K]``.

    Returns ``T[K, 2, 2]`` (and ``dT/dlam [K, 2, 2]`` when requested —
    already multiplied by the CF stage scale, reference :207-210).
    """
    q = jnp.asarray(q)
    cdt = complex_dtype_of(q)
    q, r = q.astype(cdt), jnp.asarray(r).astype(cdt)
    lam = jnp.asarray(lam).astype(cdt)
    xs, step_fn, scl = _family_inputs(q, r, eps_t, disc)

    if _use_log_depth():
        u, du = _all_step_matrices(xs, step_fn, lam, derivative)
        t, td = _tree_product(u, du)
    else:
        # single-core CPU: the sequential recurrence is cheaper than
        # materializing all step matrices
        k = lam.shape[0]
        eye = jnp.broadcast_to(jnp.eye(2, dtype=cdt), (k, 2, 2))

        def body(carry, x):
            t_, td_ = carry
            u, du = step_fn(lam, x[0], x[1], x[2], derivative=derivative)
            t_new = u @ t_
            td_new = du @ t_ + u @ td_ if derivative else td_
            return (t_new, td_new), None

        (t, td), _ = jax.lax.scan(body, (eye, jnp.zeros_like(eye)), xs)
    if derivative:
        return t, td * scl
    return t


def _mat_scan(m):
    """Inclusive prefix products (later factors left) without derivatives."""
    return jax.lax.associative_scan(lambda a, b: b @ a, m, axis=0)


def _pick_chunk_len(s: int, store_every: int) -> int:
    """Largest chunk length L = store_every * 2^k <= ~4096 dividing ``s``."""
    base = s // store_every
    g = 1
    while g * 2 <= max(1, 4096 // store_every) and base % (g * 2) == 0:
        g *= 2
    return g * store_every


# above this many steps the one-shot associative_scan trajectory
# [S, K, 2, 2] is traded for the two-pass chunked sweeps below
_CHUNK_THRESHOLD = 1 << 15


def _bound_states_chunked(xs, step_fn, lam, phi0, dphi0, psi_end, te, scl,
                          store_every: int, chunk_len: int, skip_b: bool):
    """Two-pass phi/psi sweeps with O(S/L + L) live memory.

    The reference stores phi at all D+1 grid points in host RAM
    (fnft__nse_scatter_bound_states.c:29-668); at D=2^20 a device should not hold
    the [S, K, 2, 2] prefix trajectory, so pass 1 reduces each length-L
    chunk to a single transfer matrix (tree product) and prefix-scans the
    C = S/L chunk products, and pass 2 re-derives the per-sample phi/psi
    values chunk by chunk, streaming the b error-metric argmin instead of
    materializing the trajectories.
    """
    s = jax.tree.leaves(xs)[0].shape[0]
    c_num = s // chunk_len
    xs_c = jax.tree.map(
        lambda a_: a_.reshape((c_num, chunk_len) + a_.shape[1:]), xs)

    # ---- pass 1 forward: chunk products with derivative -----------------
    def fwd_chunk(xc):
        u, du = _all_step_matrices(xc, step_fn, lam, derivative=True)
        return _tree_product(u, du)

    ms, dms = jax.lax.map(fwd_chunk, xs_c)                 # [C, K, 2, 2]
    pm, pd = jax.lax.associative_scan(_pair_combine, (ms, dms), axis=0)
    phi_end = jnp.einsum("kij,kj->ki", pm[-1], phi0)
    dphi_end = jnp.einsum("kij,kj->ki", pd[-1], phi0) + \
        jnp.einsum("kij,kj->ki", pm[-1], dphi0)
    a = phi_end[:, 0] * jnp.exp(1j * lam * te)
    aprime = scl * (dphi_end[:, 0] * jnp.exp(1j * lam * te) + (1j * te) * a)
    if skip_b:
        return a, aprime, jnp.zeros_like(a)

    # phi at each chunk's left edge (grid position c*L)
    phi_b = jnp.concatenate(
        [phi0[None], jnp.einsum("ckij,kj->cki", pm[:-1], phi0)], axis=0)

    # ---- pass 1 backward: psi chunk products ----------------------------
    xs_rev_c = jax.tree.map(
        lambda a_: a_[::-1].reshape((c_num, chunk_len) + a_.shape[1:]), xs)

    def bwd_chunk(xc):
        def one(x):
            ub, _ = step_fn(lam, x[0], x[1], x[2], derivative=False,
                            backward=True)
            return ub

        m, _ = _tree_product(jax.vmap(one)(xc), None)
        return m

    wb = jax.lax.map(bwd_chunk, xs_rev_c)                  # [C, K, 2, 2]
    qm = _mat_scan(wb)
    # psi at position S - c*L, i.e. each forward chunk's RIGHT edge
    psi_right = jnp.concatenate(
        [psi_end[None], jnp.einsum("ckij,kj->cki", qm[:-1], psi_end)],
        axis=0)[::-1]                                      # [C, K, 2]
    psi0 = jnp.einsum("kij,kj->ki", qm[-1], psi_end)       # position 0

    # ---- pass 2: stream the per-sample error metric ---------------------
    def metric_of(phi_s, psi_s):
        ratio = (phi_s[..., 1] / psi_s[..., 1]) / \
                (phi_s[..., 0] / psi_s[..., 0])
        metric = jnp.abs(0.5 * jnp.log(jnp.abs(ratio)))
        return jnp.where(jnp.isnan(metric), jnp.inf, metric), \
            phi_s[..., 0] / psi_s[..., 0]

    def body(carry, inp):
        best_m, best_b = carry
        xc, phi_bc, psi_rc = inp
        u, _ = _all_step_matrices(xc, step_fn, lam, derivative=False)
        lp = _mat_scan(u)
        phi_vals = jnp.einsum("lkij,kj->lki", lp, phi_bc)  # pos cL+1..(c+1)L
        xc_rev = jax.tree.map(lambda a_: a_[::-1], xc)

        def oneb(x):
            ub, _ = step_fn(lam, x[0], x[1], x[2], derivative=False,
                            backward=True)
            return ub

        rb = _mat_scan(jax.vmap(oneb)(xc_rev))
        psi_rev = jnp.einsum("lkij,kj->lki", rb, psi_rc)   # pos (c+1)L-1..cL
        psi_vals = jnp.concatenate([psi_rev[::-1][1:], psi_rc[None]], axis=0)
        phi_s = phi_vals[store_every - 1::store_every]
        psi_s = psi_vals[store_every - 1::store_every]
        metric, bc = metric_of(phi_s, psi_s)
        j = jnp.argmin(metric, axis=0)
        m_loc = jnp.take_along_axis(metric, j[None, :], axis=0)[0]
        b_loc = jnp.take_along_axis(bc, j[None, :], axis=0)[0]
        better = m_loc < best_m
        return (jnp.where(better, m_loc, best_m),
                jnp.where(better, b_loc, best_b)), None

    m0, b0 = metric_of(phi0, psi0)
    (_, best_b), _ = jax.lax.scan(body, (m0, b0), (xs_c, phi_b, psi_right))
    return a, aprime, best_b


@partial(jax.jit, static_argnames=("eps_t", "t0", "t1", "disc", "skip_b"))
def scatter_bound_states(q, r, lam, eps_t: float, t0: float, t1: float,
                         disc: Discretization, *, skip_b: bool = False):
    """a(lam), a'(lam) and b(lam) at bound states via phi/psi sweeps.

    phi scatters forward from T[0], storing its value at every original
    sample; psi scatters backward from T[1]; b is read off at the grid point
    minimizing |log| phi2 psi1 / (psi2 phi1)||/2 (the error metric of
    DOI 10.1109/ACCESS.2019.2932256; reference bound_states.c:642-654).

    Returns (a, a_prime, b), each ``[K]``.
    """
    q = jnp.asarray(q)
    cdt = complex_dtype_of(q)
    q, r = q.astype(cdt), jnp.asarray(r).astype(cdt)
    lam = jnp.asarray(lam).astype(cdt)
    ups = upsampling_factor(disc)
    d_given = q.shape[-1] // ups
    xs, step_fn, scl = _family_inputs(q, r, eps_t, disc)
    steps_per_sample = 1 if disc in _CF_FAMILY else 3
    store_every = ups if disc in _CF_FAMILY else 1
    del steps_per_sample

    k = lam.shape[0]
    tb = t0 - eps_t * BOUNDARY_COEFF
    te = t1 + eps_t * BOUNDARY_COEFF

    # ---- forward phi sweep (with derivative) --------------------------------
    # prefix products P_n = U_n ... U_1 via associative scan: log-depth on accelerators
    phi0 = jnp.stack([jnp.exp(-1j * lam * tb), jnp.zeros_like(lam)], axis=-1)
    dphi0 = jnp.stack([phi0[:, 0] * (-1j * tb), jnp.zeros_like(lam)], axis=-1)

    s_len = jax.tree.leaves(xs)[0].shape[0]
    chunk_len = _pick_chunk_len(s_len, store_every)
    if s_len >= _CHUNK_THRESHOLD and chunk_len >= 256 * store_every:
        psi_end0 = jnp.stack([jnp.zeros_like(lam),
                              jnp.exp(1j * lam * te)], axis=-1)
        return _bound_states_chunked(xs, step_fn, lam, phi0, dphi0, psi_end0,
                                     te, scl, store_every, chunk_len, skip_b)

    if _use_log_depth():
        u, du = _all_step_matrices(xs, step_fn, lam, derivative=True)
        pm, pd = jax.lax.associative_scan(_pair_combine, (u, du), axis=0)
        phi_traj = jnp.einsum("skij,kj->ski", pm, phi0)
        phi_end = phi_traj[-1]
        dphi_end = jnp.einsum("kij,kj->ki", pd[-1], phi0) + \
            jnp.einsum("kij,kj->ki", pm[-1], dphi0)
    else:
        def fwd(carry, x):
            v, dv = carry
            u, du = step_fn(lam, x[0], x[1], x[2], derivative=True)
            v_new = jnp.einsum("kij,kj->ki", u, v)
            dv_new = jnp.einsum("kij,kj->ki", du, v) + \
                jnp.einsum("kij,kj->ki", u, dv)
            return (v_new, dv_new), v_new

        (phi_end, dphi_end), phi_traj = jax.lax.scan(fwd, (phi0, dphi0), xs)
    phi_samples = jnp.concatenate(
        [phi0[None], phi_traj[store_every - 1::store_every]], axis=0)  # [D_given+1, K, 2]

    a = phi_end[:, 0] * jnp.exp(1j * lam * te)
    aprime = scl * (dphi_end[:, 0] * jnp.exp(1j * lam * te) + (1j * te) * a)

    if skip_b:
        return a, aprime, jnp.zeros_like(a)

    # ---- backward psi sweep -------------------------------------------------
    psi_end = jnp.stack([jnp.zeros_like(lam), jnp.exp(1j * lam * te)], axis=-1)

    xs_rev = jax.tree.map(lambda a_: a_[::-1], xs)
    if _use_log_depth():
        def one_bwd(x):
            ub, _ = step_fn(lam, x[0], x[1], x[2], derivative=False,
                            backward=True)
            return ub

        w = jax.vmap(one_bwd)(xs_rev)
        rm, _ = jax.lax.associative_scan(_pair_combine, (w, jnp.zeros_like(w)),
                                         axis=0)
        psi_traj = jnp.einsum("skij,kj->ski", rm, psi_end)
    else:
        def bwd(carry, x):
            u, _ = step_fn(lam, x[0], x[1], x[2], derivative=False,
                           backward=True)
            v_new = jnp.einsum("kij,kj->ki", u, carry)
            return v_new, v_new

        _, psi_traj = jax.lax.scan(bwd, psi_end, xs_rev)
    # psi_traj[i] = psi after undoing steps D-1 .. D-1-i; stored samples are
    # at original grid points D_given-1 .. 0
    psi_samples_rev = jnp.concatenate(
        [psi_end[None], psi_traj[store_every - 1::store_every]], axis=0)
    psi_samples = psi_samples_rev[::-1]  # [D_given+1, K, 2]

    ratio = (phi_samples[..., 1] / psi_samples[..., 1]) / \
            (phi_samples[..., 0] / psi_samples[..., 0])
    metric = jnp.abs(0.5 * jnp.log(jnp.abs(ratio)))
    metric = jnp.where(jnp.isnan(metric), jnp.inf, metric)
    n_best = jnp.argmin(metric, axis=0)  # [K]
    b = jnp.take_along_axis(phi_samples[..., 0], n_best[None, :], axis=0)[0] / \
        jnp.take_along_axis(psi_samples[..., 0], n_best[None, :], axis=0)[0]
    return a, aprime, b
