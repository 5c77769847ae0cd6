"""Fast inverse scattering: recover q from a transfer-matrix polynomial.

Rebuild of fnft__nse_finvscatter.c:29-366. The divide-and-conquer layer
peeling works on ascending coefficients:

  T(z) covers samples [0, D). Its low-order half (coefficients z^0..z^{d/2})
  approximates T2(z), the transfer matrix of the *later* samples [D/2, D).
  Recursing on it yields those samples and T2^{-1}(z) (up to a power of z);
  T1 = T2^{-1} T (middle coefficient window) covers the earlier samples.

Two execution strategies share the same math:

* **traced** — the recursion tree unrolls at trace time into one XLA
  program.  Ideal under ``vmap``/outer ``jit`` and for small D, but the
  program grows like O(D / scan_cutoff), so XLA compile time explodes for
  large D (minutes at D = 2^14, unusable at 2^17).
* **staged** (concrete inputs) — a host-side recursion dispatches small
  jitted kernels whose compiled executables are cached *by shape*: one
  leaf program (every leaf block has identical shape) plus two kernels
  per level.  Compile cost drops from O(D) to O(log D) while the
  arithmetic is unchanged; the sequential block order matches the
  reference C's own execution order.

Every block inverse Ti is J-symmetric — Ti22 = rev(conj(Ti11)),
Ti12 = -kappa rev(conj(Ti21)) — *by construction* (the one-sample base
matrices are, and the symmetry is closed under polynomial matrix
products; see ops.poly._value_level_sym for the same involution in the
forward tree).  Products against a Ti factor therefore FFT only its
first column and derive the other's bins as w^n conj(.), and
Ti x Ti merges also invert only the first column: half the transform
work of a generic product.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from fnft_tpu.config import complex_dtype_of
from fnft_tpu.models.discretization import Discretization, degree
from fnft_tpu.ops.poly import _mat2x2_mul
from fnft_tpu.utils.misc import next_fft_length

_FFT_THRESHOLD = 32  # below this degree, direct convolution traces leaner

_SCAN_CUTOFF = 32    # blocks at or below this degree peel sequentially

# staged path: sub-blocks of this degree run the traced recursion (one
# compile, reused for every block); above it, host-level recursion.
_STAGED_LEAF_DEG = 1024
# concrete inputs below this degree just use the monolithic traced jit
_STAGED_MIN_DEG = 2 * _STAGED_LEAF_DEG


def _jsym_complete(col11, col21, kappa: int):
    """Assemble a J-symmetric [..., 2, 2, c] matrix from its first column.

    T22 = rev(conj(T11)), T12 = -kappa rev(conj(T21)) at the nominal
    degree c - 1."""
    t12 = -kappa * jnp.conj(col21[..., ::-1])
    t22 = jnp.conj(col11[..., ::-1])
    return jnp.stack([jnp.stack([col11, t12], axis=-2),
                      jnp.stack([col21, t22], axis=-2)], axis=-3)


def _fft_jsym(x, length: int, kappa: int):
    """FFT bins of a J-symmetric matrix from 2 transforms (not 4).

    On the unit circle rev(conj(p))(z_k) = z_k^n conj(p(z_k)) with
    z_k = exp(-2i pi k / length) (the FFT's evaluation points) and n the
    nominal degree, so the second column's bins are elementwise derived."""
    f11 = jnp.fft.fft(x[..., 0, 0, :], n=length, axis=-1)
    f21 = jnp.fft.fft(x[..., 1, 0, :], n=length, axis=-1)
    n = x.shape[-1] - 1
    k = jnp.arange(length, dtype=jnp.result_type(x.real))
    w = jnp.exp((-2j * jnp.pi * n / length) * k).astype(x.dtype)
    f22 = w * jnp.conj(f11)
    f12 = (-kappa) * (w * jnp.conj(f21))
    return f11, f12, f21, f22


def _polymatmul(a, b, out_len=None, a_jsym: int | None = None,
                jsym: int | None = None, safe_from: int = 0):
    """(a @ b)(z) for [..., 2, 2, ca] x [..., 2, 2, cb] ascending coeffs.

    ``a_jsym``: kappa sign when ``a`` alone is J-symmetric (its FFT runs
    on the first column only).  ``jsym``: kappa sign when *both* factors
    and hence the product are J-symmetric (2 output inverse transforms
    instead of 4, second column reconstructed exactly in coefficient
    space).  Symmetry is trusted, not checked.

    ``safe_from``: the caller only reads coefficients at indices
    >= safe_from. The FFT length then shrinks to cover just
    n_out - safe_from bins: circular aliasing folds the tail
    coefficients j >= L onto j - L < safe_from — positions the caller
    never reads. (The T1 peel window [d2, deg] qualifies: the product's
    true degree is deg + d2, and deg + d2 - L < d2 for L >= deg + 1, so
    every alias lands strictly below the window.)"""
    ca, cb = a.shape[-1], b.shape[-1]
    n_out = ca + cb - 1
    if min(ca, cb) <= _FFT_THRESHOLD:
        # direct convolution via dot over a sliding window: build b's
        # convolution matrix implicitly with padding + gather-free slices
        out = jnp.zeros(a.shape[:-1] + (n_out,), dtype=a.dtype)
        for s in range(ca):
            seg = _mat2x2_mul(a[..., s:s + 1], b)
            out = out.at[..., s:s + cb].add(seg)
    else:
        length = next_fft_length(max(n_out - safe_from,
                                     (out_len or n_out) - safe_from))
        if jsym is not None or a_jsym is not None:
            fa11, fa12, fa21, fa22 = _fft_jsym(a, length,
                                               jsym if jsym is not None
                                               else a_jsym)
        else:
            fa = jnp.fft.fft(a, n=length, axis=-1)
            fa11, fa12 = fa[..., 0, 0, :], fa[..., 0, 1, :]
            fa21, fa22 = fa[..., 1, 0, :], fa[..., 1, 1, :]
        if jsym is not None:
            fb11, _, fb21, _ = _fft_jsym(b, length, jsym)
            o11 = fa11 * fb11 + fa12 * fb21
            o21 = fa21 * fb11 + fa22 * fb21
            c11 = jnp.fft.ifft(o11, axis=-1)[..., :n_out].astype(a.dtype)
            c21 = jnp.fft.ifft(o21, axis=-1)[..., :n_out].astype(a.dtype)
            out = _jsym_complete(c11, c21, jsym)
        else:
            fb = jnp.fft.fft(b, n=length, axis=-1)
            fb11, fb12 = fb[..., 0, 0, :], fb[..., 0, 1, :]
            fb21, fb22 = fb[..., 1, 0, :], fb[..., 1, 1, :]
            rows = [fa11 * fb11 + fa12 * fb21, fa11 * fb12 + fa12 * fb22,
                    fa21 * fb11 + fa22 * fb21, fa21 * fb12 + fa22 * fb22]
            f_out = jnp.stack(rows, axis=-2)
            c_out = jnp.fft.ifft(f_out, axis=-1).astype(a.dtype)
            keep = min(n_out, c_out.shape[-1])   # < n_out when safe_from
            c_out = c_out[..., :keep]
            out = c_out.reshape(c_out.shape[:-2] + (2, 2, keep))
    if out_len is not None:
        out = out[..., :out_len]
    return out


# ---------------------------------------------------------------------------
# column-only carry: J-symmetry + row-action structure make the whole
# recursion a function of the FIRST matrix column alone
# ---------------------------------------------------------------------------
# Two independent facts compose:
#  * every block (T windows and Ti inverses) is J-symmetric, so its
#    second column is the involution of the first — products against it
#    need only first-column FFT bins (_fft_jsym);
#  * left-multiplication acts on ROWS, so the two columns of T evolve
#    independently through the peel, and every read (base-case ratio
#    T10/T00, coefficient windows, the q samples) touches column 1 only.
# Carrying (c11, c21) instead of [2, 2, c] halves the peel-scan
# arithmetic and drops the t1 window product from 10 transforms
# (2 fwd a + 4 fwd b + 4 inv) to 6 (2 + 2 + 2).


def _fft_jsym_col(c11, c21, length: int, kappa: int):
    """J-symmetric FFT bins from first-column coefficient arrays."""
    f11 = jnp.fft.fft(c11, n=length, axis=-1)
    f21 = jnp.fft.fft(c21, n=length, axis=-1)
    n = c11.shape[-1] - 1
    k = jnp.arange(length, dtype=jnp.result_type(c11.real))
    w = jnp.exp((-2j * jnp.pi * n / length) * k).astype(c11.dtype)
    return f11, (-kappa) * (w * jnp.conj(f21)), f21, w * jnp.conj(f11)


def _polymatmul_col(a_col, b_col, kappa: int, out_len=None,
                    safe_from: int = 0):
    """First column of (A @ B) for J-symmetric A given B's first column.

    a_col, b_col: (c11, c21) ascending-coefficient pairs. Output column
    (o11, o21) of length out_len (or full). ``safe_from`` as in
    :func:`_polymatmul` (alias-shortened circular transforms).
    """
    a11, a21 = a_col
    b11, b21 = b_col
    ca, cb = a11.shape[-1], b11.shape[-1]
    n_out = ca + cb - 1
    if min(ca, cb) <= _FFT_THRESHOLD:
        # direct: materialize A's second-column coefficients (cheap) and
        # convolve four column pairs
        a12 = -kappa * jnp.conj(a21[..., ::-1])
        o11 = jnp.zeros(b11.shape[:-1] + (n_out,), b11.dtype)
        o21 = jnp.zeros_like(o11)
        a22 = jnp.conj(a11[..., ::-1])
        for s in range(ca):
            o11 = o11.at[..., s:s + cb].add(
                a11[..., s:s + 1] * b11 + a12[..., s:s + 1] * b21)
            o21 = o21.at[..., s:s + cb].add(
                a21[..., s:s + 1] * b11 + a22[..., s:s + 1] * b21)
    else:
        length = next_fft_length(max(n_out - safe_from,
                                     (out_len or n_out) - safe_from))
        fa11, fa12, fa21, fa22 = _fft_jsym_col(a11, a21, length, kappa)
        fb11 = jnp.fft.fft(b11, n=length, axis=-1)
        fb21 = jnp.fft.fft(b21, n=length, axis=-1)
        v11 = fa11 * fb11 + fa12 * fb21
        v21 = fa21 * fb11 + fa22 * fb21
        o11 = jnp.fft.ifft(v11, axis=-1).astype(b11.dtype)
        o21 = jnp.fft.ifft(v21, axis=-1).astype(b11.dtype)
        keep = min(n_out, o11.shape[-1])
        o11, o21 = o11[..., :keep], o21[..., :keep]
    if out_len is not None:
        o11, o21 = o11[..., :out_len], o21[..., :out_len]
    return o11, o21


def _base_case_col(c11_0, c21_0, eps_t: float, kappa: int,
                   disc: Discretization):
    """One-sample inversion from the two lowest first-column coefficients.

    Returns (q_sample, scl, qq): Ti's nonzero entries are
    z [[scl, -scl qq], [0, 0]] + [[0, 0], [scl kappa conj(qq), scl]].
    """
    qq = -kappa * jnp.conj(c21_0 / c11_0)
    abs_q = jnp.abs(qq)
    scl = 1.0 / jnp.sqrt((1.0 + kappa * abs_q * abs_q).astype(c11_0.dtype))
    if disc is Discretization.SPLIT2A:
        q_sample = jnp.arctan(abs_q) * jnp.exp(1j * jnp.angle(qq)) / eps_t
    elif disc is Discretization.SPLIT2_MODAL:
        q_sample = qq / eps_t
    else:
        raise ValueError(
            f"finvscatter supports 2SPLIT2A/2SPLIT2_MODAL, got {disc}")
    return q_sample, scl, qq


def _peel_scan_col(t_col, deg: int, eps_t: float, kappa: int,
                   disc: Discretization):
    """Column-only sequential peel (cf. :func:`_peel_scan`'s math)."""
    c = deg + 1

    def step(carry, _):
        (c11, c21), (u, v) = carry
        q_s, scl, qq = _base_case_col(c11[..., 0], c21[..., 0], eps_t,
                                      kappa, disc)
        s_, q_ = scl[..., None], qq[..., None]
        kq = (kappa * scl * jnp.conj(qq))[..., None]
        c11n = s_ * c11 - s_ * q_ * c21
        c21n = jnp.pad((kq * c11 + s_ * c21)[..., 1:],
                       [(0, 0)] * (c11.ndim - 1) + [(0, 1)])
        s0 = s_ * u - s_ * q_ * v
        un = jnp.pad(s0[..., :-1], [(0, 0)] * (u.ndim - 1) + [(1, 0)])
        vn = kq * u + s_ * v
        return ((c11n, c21n), (un, vn)), q_s

    lead = t_col[0].shape[:-1]
    u0 = jnp.zeros(lead + (c,), t_col[0].dtype).at[..., 0].set(1.0)
    v0 = jnp.zeros_like(u0)
    (_, acc), q_rev = jax.lax.scan(step, (t_col, (u0, v0)), None,
                                   length=deg)
    q = jnp.moveaxis(q_rev, 0, -1)[..., ::-1]
    return q, acc


def _recurse_col(t_col, deg: int, eps_t: float, kappa: int,
                 disc: Discretization, need_inverse: bool):
    """Column-carry recursion: (q [..., deg], ti_col or None)."""
    if 1 < deg <= _SCAN_CUTOFF:
        q, ti_col = _peel_scan_col(t_col, deg, eps_t, kappa, disc)
        return q, (ti_col if need_inverse else None)
    if deg == 1:
        q_s, scl, qq = _base_case_col(t_col[0][..., 0], t_col[1][..., 0],
                                      eps_t, kappa, disc)
        z = jnp.zeros_like(scl)
        i11 = jnp.stack([z, scl], axis=-1)
        i21 = jnp.stack([kappa * scl * jnp.conj(qq), z], axis=-1)
        return q_s[..., None], ((i11, i21) if need_inverse else None)
    d2 = deg // 2
    t2_col = (t_col[0][..., :d2 + 1], t_col[1][..., :d2 + 1])
    q_hi, t2i = _recurse_col(t2_col, d2, eps_t, kappa, disc, True)
    prod = _polymatmul_col(t2i, t_col, kappa, out_len=deg + 1,
                           safe_from=d2)
    t1_col = (prod[0][..., d2: deg + 1], prod[1][..., d2: deg + 1])
    q_lo, t1i = _recurse_col(t1_col, d2, eps_t, kappa, disc, need_inverse)
    ti = _polymatmul_col(t1i, t2i, kappa) if need_inverse else None
    return jnp.concatenate([q_lo, q_hi], axis=-1), ti


@partial(jax.jit,
         static_argnames=("deg", "eps_t", "kappa", "disc", "need_inverse"))
def _recurse_col_jit(t11, t21, deg: int, eps_t: float, kappa: int,
                     disc: Discretization, need_inverse: bool):
    q, ti = _recurse_col((t11, t21), deg, eps_t, kappa, disc, need_inverse)
    return (q, ti[0], ti[1]) if need_inverse else (q,)


@partial(jax.jit, static_argnames=("d2", "deg", "kappa"))
def _t1_stage_col(i11, i21, t11, t21, d2: int, deg: int, kappa: int):
    o11, o21 = _polymatmul_col((i11, i21), (t11, t21), kappa,
                               out_len=deg + 1, safe_from=d2)
    return o11[..., d2: deg + 1], o21[..., d2: deg + 1]


@partial(jax.jit, static_argnames=("kappa",))
def _merge_stage_col(a11, a21, b11, b21, kappa: int):
    return _polymatmul_col((a11, a21), (b11, b21), kappa)


def _recurse_staged_col(t_col, deg: int, eps_t: float, kappa: int,
                        disc: Discretization, need_inverse: bool,
                        out: list, offset: int):
    if deg <= _STAGED_LEAF_DEG:
        res = _recurse_col_jit(t_col[0], t_col[1], deg, eps_t, kappa,
                               disc, need_inverse)
        out.append((offset, res[0]))
        return (res[1], res[2]) if need_inverse else None
    d2 = deg // 2
    t2_col = (t_col[0][..., :d2 + 1], t_col[1][..., :d2 + 1])
    t2i = _recurse_staged_col(t2_col, d2, eps_t, kappa, disc, True, out,
                              offset + d2)
    t1_col = _t1_stage_col(t2i[0], t2i[1], t_col[0], t_col[1], d2, deg,
                           kappa)
    t1i = _recurse_staged_col(t1_col, d2, eps_t, kappa, disc,
                              need_inverse, out, offset)
    if not need_inverse:
        return None
    return _merge_stage_col(t1i[0], t1i[1], t2i[0], t2i[1], kappa)


def _base_case(t, eps_t: float, kappa: int, disc: Discretization):
    """One-sample inversion (reference :167-227).

    Returns (q_sample, Ti[2,2,2]) with Ti the inverse one-step matrix
    (up to a factor z).
    """
    cdt = t.dtype
    qq = -kappa * jnp.conj(t[..., 1, 0, 0] / t[..., 0, 0, 0])
    abs_q = jnp.abs(qq)
    scl_den = 1.0 + kappa * abs_q * abs_q
    scl = 1.0 / jnp.sqrt(scl_den.astype(cdt))
    if disc is Discretization.SPLIT2A:
        q_sample = jnp.arctan(abs_q) * jnp.exp(1j * jnp.angle(qq)) / eps_t
    elif disc is Discretization.SPLIT2_MODAL:
        q_sample = qq / eps_t
    else:
        raise ValueError(f"finvscatter supports 2SPLIT2A/2SPLIT2_MODAL, got {disc}")
    ti = jnp.zeros(t.shape[:-3] + (2, 2, 2), dtype=cdt)
    ti = ti.at[..., 0, 0, 1].set(scl)
    ti = ti.at[..., 0, 1, 1].set(-scl * qq)
    ti = ti.at[..., 1, 0, 0].set(scl * kappa * jnp.conj(qq))
    ti = ti.at[..., 1, 1, 0].set(scl)
    return q_sample, ti


def _peel_scan(t, deg: int, eps_t: float, kappa: int, disc: Discretization):
    """Sequential one-sample layer peel of a whole block via lax.scan.

    The divide-and-conquer split generalizes to (deg-1, 1): the two lowest
    coefficients of T are the last sample's one-step matrix (verified exact
    for 2SPLIT2A/MODAL). O(deg^2) work but O(1) trace size — used for the
    small blocks at the bottom of the recursion where the tree would
    otherwise dominate XLA compile time.

    The accumulated block inverse is J-symmetric, so the scan carries
    only its first column (half the accumulation work) and the full
    matrix is reconstructed once at exit.

    Returns (q [..., deg] natural order, Ti [..., 2, 2, deg+1]).
    """
    c = deg + 1

    def step(carry, _):
        t_cur, acc = carry                       # acc: [..., 2, c] column
        q_s, ti = _base_case(t_cur[..., :2], eps_t, kappa, disc)
        # the one-sample inverse factor is structurally sparse:
        #   Ti = z [[scl, -scl q], [0, 0]] + [[0, 0], [scl k conj(q), scl]]
        # so (Ti @ T)[1 : c+1] and the left column accumulation collapse
        # to two row combinations each (no generic polymatmul needed)
        scl = ti[..., 0, 0, 1]
        mq = ti[..., 0, 1, 1]                    # -scl * q
        kcq = ti[..., 1, 0, 0]                   # scl * kappa * conj(q)
        s_, m_, k_ = (scl[..., None, None], mq[..., None, None],
                      kcq[..., None, None])
        row0, row1 = t_cur[..., 0, :, :], t_cur[..., 1, :, :]
        t_next = jnp.stack(
            [s_ * row0 + m_ * row1,
             jnp.pad((k_ * row0 + s_ * row1)[..., 1:],
                     [(0, 0)] * (row0.ndim - 1) + [(0, 1)])], axis=-3)
        u, v = acc[..., 0, :], acc[..., 1, :]
        sa, ma, ka = scl[..., None], mq[..., None], kcq[..., None]
        s0 = sa * u + ma * v                     # z-coefficient row 0
        acc = jnp.stack(
            [jnp.pad(s0[..., :-1], [(0, 0)] * (u.ndim - 1) + [(1, 0)]),
             ka * u + sa * v], axis=-2)
        return (t_next, acc), q_s

    eye = jnp.zeros(t.shape[:-3] + (2, c), dtype=t.dtype)
    eye = eye.at[..., 0, 0].set(1.0)
    (t_fin, acc), q_rev = jax.lax.scan(step, (t, eye), None, length=deg)
    q = jnp.moveaxis(q_rev, 0, -1)[..., ::-1]
    ti_total = _jsym_complete(acc[..., 0, :], acc[..., 1, :], kappa)
    return q, ti_total


def _recurse(t, deg: int, eps_t: float, kappa: int, disc: Discretization,
             need_inverse: bool):
    """Returns (q_samples [..., deg] in natural time order, Ti or None)."""
    if 1 < deg <= _SCAN_CUTOFF:
        q, ti = _peel_scan(t, deg, eps_t, kappa, disc)
        return q, (ti if need_inverse else None)
    if deg == 1:
        q_sample, ti = _base_case(t, eps_t, kappa, disc)
        return q_sample[..., None], (ti if need_inverse else None)
    d2 = deg // 2
    # later samples: low-order coefficient half approximates T2
    t2_approx = t[..., :d2 + 1]
    q_hi, t2i = _recurse(t2_approx, d2, eps_t, kappa, disc, True)
    # T1 = T2i * T; true T1 sits in the coefficient window [d2, deg]
    prod = _polymatmul(t2i, t, out_len=deg + 1, a_jsym=kappa, safe_from=d2)
    t1 = prod[..., d2: deg + 1]
    q_lo, t1i = _recurse(t1, d2, eps_t, kappa, disc, need_inverse)
    ti = _polymatmul(t1i, t2i, jsym=kappa) if need_inverse else None
    return jnp.concatenate([q_lo, q_hi], axis=-1), ti


@partial(jax.jit,
         static_argnames=("deg", "eps_t", "kappa", "disc", "need_inverse"))
def _recurse_jit(t, deg: int, eps_t: float, kappa: int,
                 disc: Discretization, need_inverse: bool):
    """Shape-cached traced recursion: the staged driver's leaf program
    (compiled once, reused for every same-shape sub-block)."""
    return _recurse(t, deg, eps_t, kappa, disc, need_inverse)


@partial(jax.jit, static_argnames=("d2", "deg", "kappa"))
def _t1_stage(t2i, t, d2: int, deg: int, kappa: int):
    """T1 window: (T2i @ T)[d2 : deg+1], T2i J-symmetric."""
    prod = _polymatmul(t2i, t, out_len=deg + 1, a_jsym=kappa, safe_from=d2)
    return prod[..., d2: deg + 1]


@partial(jax.jit, static_argnames=("kappa",))
def _merge_stage(t1i, t2i, kappa: int):
    """Block-inverse merge Ti = T1i @ T2i of two J-symmetric factors."""
    return _polymatmul(t1i, t2i, jsym=kappa)


def _recurse_staged(t, deg: int, eps_t: float, kappa: int,
                    disc: Discretization, need_inverse: bool,
                    out: list, offset: int):
    """Host-level recursion over shape-cached jitted kernels.

    Leaf q blocks land in ``out`` as (sample_offset, block); the caller
    concatenates them once in time order.  Compile cost is O(log D):
    one traced leaf program plus two kernels per level.
    """
    if deg <= _STAGED_LEAF_DEG:
        q, ti = _recurse_jit(t, deg, eps_t, kappa, disc, need_inverse)
        out.append((offset, q))
        return ti
    d2 = deg // 2
    t2i = _recurse_staged(t[..., :d2 + 1], d2, eps_t, kappa, disc, True,
                          out, offset + d2)
    t1 = _t1_stage(t2i, t, d2, deg, kappa)
    t1i = _recurse_staged(t1, d2, eps_t, kappa, disc, need_inverse,
                          out, offset)
    return _merge_stage(t1i, t2i, kappa) if need_inverse else None


@partial(jax.jit, static_argnames=("eps_t", "kappa", "disc"))
def _finvscatter_traced(t, eps_t: float, kappa: int, disc: Discretization):
    deg = t.shape[-1] - 1
    q, _ = _recurse_col((t[..., 0, 0, :], t[..., 1, 0, :]), deg, eps_t,
                        kappa, disc, need_inverse=False)
    return q


def finvscatter(transfer_matrix, eps_t: float, kappa: int,
                disc: Discretization = Discretization.SPLIT2A):
    """Recover D = deg/deg1 samples from T ``[..., 2, 2, deg+1]`` (ascending).

    D must be a power of two (reference :265-267).  Concrete inputs at
    large D run the staged driver (host recursion over shape-cached
    kernels — O(log D) compiles); traced inputs (under jit/vmap) and
    small D use the fully traced recursion.
    """
    t = jnp.asarray(transfer_matrix)
    cdt = complex_dtype_of(t)
    t = t.astype(cdt)
    deg = t.shape[-1] - 1
    d = deg // max(degree(disc), 1)
    if d < 2 or d & (d - 1):
        raise ValueError("D must be a positive power of two")
    if isinstance(t, jax.core.Tracer) or deg < _STAGED_MIN_DEG:
        return _finvscatter_traced(t, eps_t, kappa, disc)
    out: list = []
    _recurse_staged_col((t[..., 0, 0, :], t[..., 1, 0, :]), deg, eps_t,
                        kappa, disc, False, out, 0)
    out.sort(key=lambda kv: kv[0])
    return jnp.concatenate([blk for _, blk in out], axis=-1)
