"""Reference-accuracy forward NFT in pure float32-pair (df64) arithmetic.

Everything a float32-only device cannot do in float64 — the per-sample transfer
matrices, the fmult tree, the chirp-Z spectral evaluation, and the phase
factors — computed in df64 (fnft_tpu.ops.df64):

* the one-step zero-frequency matrix expm([[0,q],[r,0]] h) is evaluated
  through the *even* series in w = (q r) h^2:
      cos(D) = sum_k w^k/(2k)!,  h sinc(D) = h sum_k w^k/(2k+1)!
  (D = h sqrt(-q r); no square roots needed), which converges to 1e-16
  for |w| <~ 1 — always true for resolvable steps;
* the splitting combinator folds E/Z factors exactly as ops.fscatter but
  on df64 coefficient pytrees;
* chirp-Z spiral tables are computed on the host in extended precision and
  shipped as hi/lo planes.

Input/output are complex128 at the API boundary; on-device everything is
float32 pairs.
"""

from __future__ import annotations

import math
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from fnft_tpu.models.discretization import Discretization, degree, splitting_spec
from fnft_tpu.ops.df64 import (
    _cdf_index,
    _cdf_reg,
    _fft_df64,
    cdf_add,
    cdf_from_c128,
    cdf_mul,
    cdf_sub,
    cdf_to_c128,
    df_from_f64,
)
from fnft_tpu.ops.poly import _spiral_table
from fnft_tpu.ops.df64 import next_fft_length_df64 as next_fft_length  # 2^a or 3*2^a

_SERIES_TERMS = 12


def _cdf_scale_f64(x, s: float):
    """Multiply a cdf value by a host float (split into df64)."""
    sc = (jnp.float32(np.float32(s)),
          jnp.float32(np.float64(s) - np.float64(np.float32(s))))
    return (_df_mul_scalar(x[0], sc), _df_mul_scalar(x[1], sc))


def _const_cdf_like(shape, val: float):
    v32 = np.float32(val)
    return ((jnp.full(shape, v32, jnp.float32),
             jnp.full(shape, np.float32(np.float64(val) - np.float64(v32)),
                      jnp.float32)),
            (jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)))


def _df_mul_scalar(x, s):
    from fnft_tpu.ops.df64 import df_mul

    sh = jnp.broadcast_to(s[0], x[0].shape)
    sl = jnp.broadcast_to(s[1], x[0].shape)
    return df_mul(x, (sh, sl))


def _even_series(w, coeffs_f64):
    """sum_k c_k w^k in cdf arithmetic (w complex df64, c_k host floats)."""
    # Horner from the highest term
    acc = None
    for ck in reversed(coeffs_f64):
        ck32 = np.float32(ck)
        term = ((jnp.broadcast_to(jnp.float32(ck32), w[0][0].shape),
                 jnp.broadcast_to(jnp.float32(np.float64(ck)
                                              - np.float64(ck32)),
                                  w[0][0].shape)),
                (jnp.zeros_like(w[0][0]), jnp.zeros_like(w[0][0])))
        acc = term if acc is None else cdf_add(cdf_mul(acc, w), term)
    return acc


def _zero_freq_matrix_df64(q, r, h: float):
    """df64 entries (E00, E01, E10) of expm([[0,q],[r,0]] h) via series."""
    qr = cdf_mul(q, r)
    w = _cdf_scale_f64(qr, h * h)           # w = q r h^2 = -Delta^2... sign:
    # cos(D) with D^2 = -q r h^2: cos(D) = sum (-1)^k D^2k/(2k)! =
    # sum (q r h^2)^k/(2k)!  -> even series in +w
    cos_c = [1.0 / math.factorial(2 * k) for k in range(_SERIES_TERMS)]
    sinc_c = [1.0 / math.factorial(2 * k + 1) for k in range(_SERIES_TERMS)]
    e00 = _even_series(w, cos_c)
    hsinc = _cdf_scale_f64(_even_series(w, sinc_c), h)
    e01 = cdf_mul(q, hsinc)
    e10 = cdf_mul(r, hsinc)
    return e00, e01, e10


def transfer_matrix_coeffs_df64(q, r, eps_t: float, disc: Discretization):
    """df64 per-sample polynomial matrices; mirrors ops.fscatter.

    The polynomial is carried as per-entry COEFFICIENT LISTS (None =
    structural zero) and assembled into the dense [d, 2, 2, deg+1] array
    with a single stack at the end: long dynamic-update-slice chains make
    XLA:CPU's optimizer pathologically slow ("Very slow compile" alarms)
    once this function is jitted.
    """
    deg = degree(disc)
    if deg == 0 or disc is Discretization.SPLIT2_MODAL:
        raise ValueError(f"df64 pipeline supports splitting schemes, got {disc}")
    spec = splitting_spec(disc)
    e_weights = sorted({a for _, fs in spec for kind, a in fs if kind == "E"})
    e_mats = {a: _zero_freq_matrix_df64(q, r, a * eps_t / deg)
              for a in e_weights}

    d = q[0][0].shape[-1]
    shape = q[0][0].shape

    # total[i][j][k]: cdf scalar [d] or None
    total = [[[None] * (deg + 1) for _ in range(2)] for _ in range(2)]
    for coeff, factors in spec:
        p = None  # p[i][j] = coefficient list of cdf scalars / None
        for kind, a in factors:
            if kind == "E":
                e00, e01, e10 = e_mats[a]
                ent = {(0, 0): e00, (0, 1): e01, (1, 0): e10, (1, 1): e00}
                if p is None:
                    p = [[[e00], [e01]], [[e10], [e00]]]
                else:
                    clen = len(p[0][0])
                    nxt = [[None, None], [None, None]]
                    for i in range(2):
                        for j in range(2):
                            lst = []
                            for k in range(clen):
                                acc = None
                                for l in range(2):
                                    if p[i][l][k] is None:
                                        continue
                                    term = cdf_mul(p[i][l][k], ent[(l, j)])
                                    acc = term if acc is None \
                                        else cdf_add(acc, term)
                                lst.append(acc)
                            nxt[i][j] = lst
                    p = nxt
            else:
                ai = int(round(a))
                if p is None:
                    one = _const_cdf_like(shape, 1.0)
                    # diag(1, z^a)
                    p = [[[one] + [None] * ai, [None] * (ai + 1)],
                         [[None] * (ai + 1), [None] * ai + [one]]]
                else:
                    # right-multiply by diag(1, z^a): column 1 shifts up by a
                    for i in range(2):
                        p[i][1] = [None] * ai + p[i][1]
                        p[i][0] = p[i][0] + [None] * ai
        for i in range(2):
            for j in range(2):
                lst = p[i][j] + [None] * ((deg + 1) - len(p[i][j]))
                for k in range(deg + 1):
                    v = lst[k]
                    if v is None:
                        continue
                    v = _cdf_scale_f64(v, float(coeff))
                    total[i][j][k] = v if total[i][j][k] is None \
                        else cdf_add(total[i][j][k], v)

    zero = jnp.zeros(shape, jnp.float32)

    def plane(sel):
        return jnp.stack([
            jnp.stack([
                jnp.stack([sel(total[i][j][k]) if total[i][j][k] is not None
                           else zero for k in range(deg + 1)], axis=-1)
                for j in range(2)], axis=-2)
            for i in range(2)], axis=-3)

    del d
    return ((plane(lambda v: v[0][0]), plane(lambda v: v[0][1])),
            (plane(lambda v: v[1][0]), plane(lambda v: v[1][1])))








# ---------------------------------------------------------------------------
# df64 tree + chirp-Z + phases
# ---------------------------------------------------------------------------

# below this coefficient count the level is a direct (shift-and-add)
# convolution instead of FFTs. Default 0 (off): the pad/add chains make
# XLA:CPU's optimizer slower than the small FFTs it replaces; a tuning
# knob where tiny FFTs are launch-bound.
_DIRECT_CONV_CUTOFF_DF64 = 0


def _direct_level_df64(a, b, c: int):
    """(b @ a)(z) per pair, cdf [n2, 2, 2, c] -> [n2, 2, 2, 2c-1]."""
    rows = []
    for i in range(2):
        cols = []
        for j in range(2):
            acc = None
            for k in range(2):
                bv = _cdf_index(b, (Ellipsis, i, k, slice(None)))  # [n2, c]
                av = _cdf_index(a, (Ellipsis, k, j, slice(None)))
                for s in range(c):
                    term = cdf_mul(
                        _cdf_index(bv, (Ellipsis, slice(s, s + 1))), av)
                    padded = jax.tree.map(
                        lambda t, s=s: jnp.pad(
                            t, [(0, 0)] * (t.ndim - 1) + [(s, c - 1 - s)]),
                        term)
                    acc = padded if acc is None else cdf_add(acc, padded)
            cols.append(acc)
        rows.append(jax.tree.map(lambda *xs: jnp.stack(xs, axis=-2), *cols))
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=-3), *rows)


def _fft_level_df64(a, b, c: int):
    """(b @ a) per pair via the canonical FFT-domain product in ops.df64."""
    from fnft_tpu.ops.df64 import _matpoly_product_df64

    prod = _matpoly_product_df64(b, a, next_fft_length(2 * c - 1))
    return _cdf_index(prod, (Ellipsis, slice(0, 2 * c - 1)))


_VALUE_TREE_DF64 = True  # switch to the value-space levels when supported


def _tree_rescale_df64(p, w, extra_hi=None, tdims=0):
    """Per-matrix power-of-two rescale off the hi planes (exact in df64)."""
    hi_mag = jnp.maximum(jnp.abs(p[0][0]), jnp.abs(p[1][0]))
    max_abs = jnp.max(hi_mag, axis=(-3, -2, -1))
    if extra_hi is not None:
        max_abs = jnp.maximum(max_abs, extra_hi)
    safe = jnp.where(max_abs > 0, max_abs, 1.0)
    a_exp = jnp.where(max_abs > 0, jnp.floor(jnp.log2(safe)), 0.0)
    scale = jnp.ldexp(jnp.float32(1.0), -a_exp.astype(jnp.int32))
    scale_v = scale[(Ellipsis,) + (None,) * 3]
    p = jax.tree.map(lambda t: t * scale_v, p)
    w = w[..., 0::2] + w[..., 1::2] + a_exp.astype(jnp.int32)
    return p, w, scale


def _tree_rescale_sym_df64(V, t, c, w):
    """Per-node power-of-two rescale for the J-symmetric column state.

    The carried column's magnitudes cover the full matrix (|col2| == |col1|
    pointwise, |t12|,|t22| == |c21|,|c11|), so the max over (V, t, c) is
    the same quantity :func:`_tree_rescale_df64` computes on full nodes."""
    max_abs = jnp.max(jnp.maximum(jnp.abs(V[0][0]), jnp.abs(V[1][0])),
                      axis=(-2, -1))
    for s in (t, c):
        hi = jnp.maximum(jnp.abs(s[0][0]), jnp.abs(s[1][0]))
        max_abs = jnp.maximum(max_abs, jnp.max(hi, axis=-1))
    safe = jnp.where(max_abs > 0, max_abs, 1.0)
    a_exp = jnp.where(max_abs > 0, jnp.floor(jnp.log2(safe)), 0.0)
    scale = jnp.ldexp(jnp.float32(1.0), -a_exp.astype(jnp.int32))
    scale_v = scale[(Ellipsis,) + (None,) * 2]
    scale_s = scale[..., None]
    V = jax.tree.map(lambda x: x * scale_v, V)
    t = jax.tree.map(lambda x: x * scale_s, t)
    c = jax.tree.map(lambda x: x * scale_s, c)
    w = w[..., 0::2] + w[..., 1::2] + a_exp.astype(jnp.int32)
    return V, t, c, w


def _tree_df64(p, n_true: int, deg_in: int, want=None,
               jsym: int | None = None):
    """df64 fmult tree on cdf [..., n, 2, 2, c]; returns (cdf [...,2,2,out], w).

    Small-degree levels run the padded coefficient product; once the node
    grid N = c-1 is an exact df64 FFT length and >= 3 levels remain, the
    tree switches to value space (ops/df64._value_level_df64): ~35% less
    FFT work at the FFT-friendliest lengths.  ``want`` selects the final
    transfer-matrix entries to materialize (others return zero).  ``jsym``
    (+1/-1) asserts the J-involution symmetry of the inputs (AKNS with
    r = -jsym*conj(q)); the value levels then carry only the first matrix
    column — half the df64 FFT work (ops/df64._value_level_sym_df64).
    Requires n to be a power of two (identity padding breaks the
    symmetry); ignored otherwise.
    """
    from fnft_tpu.ops.df64 import (
        _value_enter_df64, _value_enter_sym_df64, _value_exit_df64,
        _value_exit_sym_df64, _value_level_df64, _value_level_sym_df64,
        value_grid_supported_df64)

    n = p[0][0].shape[-4]
    lead = p[0][0].shape[:-4]
    w = jnp.zeros(lead + (n,), jnp.int32)
    levels = int(math.log2(n)) if n > 1 else 0
    c = p[0][0].shape[-1]
    lv = 0
    use_sym = jsym in (1, -1) and n & (n - 1) == 0
    while lv < levels:
        if (_VALUE_TREE_DF64 and levels - lv >= 3
                and value_grid_supported_df64(c - 1)):
            break
        a = _cdf_index(p, (Ellipsis, slice(0, None, 2), slice(None),
                           slice(None), slice(None)))
        b = _cdf_index(p, (Ellipsis, slice(1, None, 2), slice(None),
                           slice(None), slice(None)))
        if c <= _DIRECT_CONV_CUTOFF_DF64:
            prod = _direct_level_df64(a, b, c)
        else:
            prod = _fft_level_df64(a, b, c)
        p, w, _ = _tree_rescale_df64(prod, w)
        c = 2 * c - 1
        lv += 1
    if lv < levels and use_sym:
        grid = c - 1
        Vc, tc, cc = _value_enter_sym_df64(p, grid)
        while lv < levels:
            Vc, tc, cc = _value_level_sym_df64(Vc, tc, cc, jsym, grid)
            grid *= 2
            Vc, tc, cc, w = _tree_rescale_sym_df64(Vc, tc, cc, w)
            lv += 1
        p = _value_exit_sym_df64(Vc, tc, cc, jsym, grid, want=want)
        return _cdf_index(p, (Ellipsis, 0, slice(None), slice(None),
                              slice(None))), w[..., 0]
    if lv < levels:
        grid = c - 1
        V, t = _value_enter_df64(p, grid)
        while lv < levels:
            V, t = _value_level_df64(V, t, grid)
            grid *= 2
            t_hi = jnp.max(jnp.maximum(jnp.abs(t[0][0]), jnp.abs(t[1][0])),
                           axis=(-2, -1))
            V, w, scale = _tree_rescale_df64(V, w, extra_hi=t_hi)
            scale_t = scale[(Ellipsis,) + (None,) * 2]
            t = jax.tree.map(lambda x: x * scale_t, t)
            lv += 1
        p = _value_exit_df64(V, t, grid, want=want)
        return _cdf_index(p, (Ellipsis, 0, slice(None), slice(None),
                              slice(None))), w[..., 0]
    if want is not None:
        from fnft_tpu.ops.poly import _want_mask

        mask = jnp.asarray(_want_mask(want))
        p = jax.tree.map(lambda x: jnp.where(mask, x, 0.0), p)
    return _cdf_index(p, (Ellipsis, 0, slice(None), slice(None),
                          slice(None))), w[..., 0]


def _chirpz_df64(coeffs, a_pt: complex, w_pt: complex, m: int):
    """df64 chirp-Z of a cdf coefficient vector.

    Spiral tables go through the table registry: at D=2^20 the three cdf
    tables total ~200 MB of literals otherwise (see ops/tables.py)."""
    n = coeffs[0][0].shape[-1]
    length = next_fft_length(n + m - 1)
    a_pt, w_pt = complex(a_pt), complex(w_pt)
    key = (n, m, a_pt, w_pt)

    def _xw():
        ks = np.arange(n, dtype=np.float64)
        return _spiral_table(a_pt, ks) * _spiral_table(w_pt, 0.5 * ks * ks)

    def _vf():
        ks = np.arange(max(n, m), dtype=np.float64)
        w_half = _spiral_table(w_pt, 0.5 * ks * ks)
        v = np.zeros(length, dtype=np.complex128)
        v[:m] = 1.0 / w_half[:m]
        neg = _spiral_table(w_pt, 0.5 * ks[1:n] * ks[1:n])
        v[length - n + 1:] = (1.0 / neg)[::-1]
        return np.fft.fft(v)

    def _wout():
        ks = np.arange(m, dtype=np.float64)
        return _spiral_table(w_pt, 0.5 * ks * ks)

    x = cdf_mul(coeffs, _cdf_reg(("df64_chirpz_xw",) + key, _xw))
    v_f = _cdf_reg(("df64_chirpz_vf",) + key, _vf)
    xf = _fft_df64(jax.tree.map(
        lambda t: jnp.pad(t, [(0, 0)] * (t.ndim - 1)
                          + [(0, length - t.shape[-1])]), x), length)
    conv = _fft_df64(cdf_mul(xf, v_f), length, inverse=True)
    out = cdf_mul(_cdf_index(conv, (Ellipsis, slice(0, m))),
                  _cdf_reg(("df64_chirpz_wout",) + key, _wout))
    return out


# The pipeline is three stages rather than one monolithic program: a
# single whole-pipeline jit triggers XLA:CPU's "Very slow compile" alarm
# (minutes-long optimization passes). The deep df64 arithmetic chains of
# the transfer-matrix stage trip the same alarm even alone, so that stage
# is jitted only on accelerator backends (eager dispatch on CPU costs a
# few seconds; per-op round-trips on an accelerator would cost far more).

def _tm_stage_df64(q_cdf, *, eps_t: float, kappa: int, disc: Discretization):
    q = q_cdf
    # r = -kappa conj(q): negate real planes, conj flips the imag sign
    r = ((-kappa * q[0][0], -kappa * q[0][1]),
         (kappa * q[1][0], kappa * q[1][1]))
    return transfer_matrix_coeffs_df64(q, r, eps_t, disc)


@partial(jax.jit, static_argnames=("n_true", "deg_in", "want", "jsym"))
def _tree_stage_df64(p, *, n_true: int, deg_in: int, want=None,
                     jsym: int | None = None):
    return _tree_df64(p, n_true, deg_in, want=want, jsym=jsym)


@partial(jax.jit, static_argnames=("a_pt", "w_pt", "m", "pf", "xi_span"))
def _spec_stage_df64(tm, *, a_pt: complex, w_pt: complex, m: int, pf: float,
                     xi_span):
    h11 = _chirpz_df64(_cdf_index(tm, (Ellipsis, 0, 0, slice(None))),
                       a_pt, w_pt, m)
    h21 = _chirpz_df64(_cdf_index(tm, (Ellipsis, 1, 0, slice(None))),
                       a_pt, w_pt, m)
    phase = _cdf_reg(
        ("df64_phase", m, xi_span[0], xi_span[1], pf),
        lambda: np.exp(1j * np.linspace(xi_span[0], xi_span[1], m) * pf))
    num = cdf_mul(h21, phase)
    return num, h11


def _contspec_df64_core(q_cdf, *, d: int, m: int, t_span, xi_span,
                        kappa: int, disc: Discretization):
    """Float32-only staged core: cdf q -> (num_cdf, h11_cdf), each [..., m].

    No float64 ops on device, so the programs run unmodified on a
    float32-only device; the persistent compilation cache
    (:func:`fnft_tpu.config.enable_compilation_cache`) makes recompiles
    one-time per machine.
    """
    from fnft_tpu.models import nse

    t0, t1 = t_span
    xi0, xi1 = xi_span
    eps_t = (t1 - t0) / (d - 1)
    deg1 = max(degree(disc), 1)
    batched = q_cdf[0][0].ndim == 2

    def staged(fn, x, **kw):
        call = partial(fn, **kw)
        return jax.vmap(call)(x) if batched else call(x)

    tm_call = partial(_tm_stage_df64, eps_t=eps_t, kappa=kappa, disc=disc)
    if jax.default_backend() == "cpu":
        # eager per-signal dispatch (see note above _tm_stage_df64)
        if batched:
            rows = [tm_call(jax.tree.map(lambda t, i=i: t[i], q_cdf))
                    for i in range(q_cdf[0][0].shape[0])]
            p = jax.tree.map(lambda *xs: jnp.stack(xs), *rows)
        else:
            p = tm_call(q_cdf)
    else:
        jit_tm = jax.jit(tm_call)
        p = jax.vmap(jit_tm)(q_cdf) if batched else jit_tm(q_cdf)
    tm, _ = staged(_tree_stage_df64, p, n_true=d, deg_in=degree(disc),
                   want=((0, 0), (1, 0)), jsym=kappa)
    # rho is a ratio: the 2^w scale cancels

    eps_xi = (xi1 - xi0) / (m - 1)
    a_pt = complex(np.exp(2j * xi0 * eps_t / deg1))
    w_pt = complex(np.exp(2j * eps_xi * eps_t / deg1))
    pf = float(nse.phase_factor_rho(eps_t, t1, disc))
    return staged(_spec_stage_df64, tm, a_pt=a_pt, w_pt=w_pt, m=m, pf=pf,
                  xi_span=(xi0, xi1))


def rho_pipeline_df64_tabled(d: int, m: int, t_span, xi_span, *,
                             kappa: int = 1,
                             disc: Discretization = Discretization.SPLIT4B,
                             batch: int | None = None):
    """Reference-accuracy contspec as one jitted real-f32 program (memoized).

    Construction requires RE-TRACING the deep df64 program (tens of
    seconds of pure Python at D=4096+), so built pipelines are cached per
    geometry: a full-spectrum run that rebuilt them spent most of each
    call re-tracing identical pipelines.
    """
    return _rho_pipeline_df64_cached(d, m, (float(t_span[0]),
                                            float(t_span[1])),
                                     (float(xi_span[0]), float(xi_span[1])),
                                     kappa, disc, batch)


@lru_cache(maxsize=32)
def _rho_pipeline_df64_cached(d: int, m: int, t_span, xi_span,
                              kappa: int, disc: Discretization,
                              batch: int | None):
    """Reference-accuracy contspec as one jitted real-f32 program.

    The complex-free twin of :func:`nsev_contspec_df64` for backends
    without complex types (ops/tpu_pipeline.py):
    takes the signal as four float32 hi/lo planes
    ``(q_re_hi, q_re_lo, q_im_hi, q_im_lo)`` (host-split from complex128
    via :func:`fnft_tpu.ops.df64._split_host_complex` semantics) and
    returns rho's four planes. Every twiddle/chirp-Z/phase table rides as
    a jit parameter (ops/tables.jit_tabled), so the compiled payload
    carries no large literals even at D=2^20.
    """
    from fnft_tpu.models import nse
    from fnft_tpu.ops import tables
    from fnft_tpu.ops.df64 import cdf_div

    t0, t1 = float(t_span[0]), float(t_span[1])
    xi0, xi1 = float(xi_span[0]), float(xi_span[1])
    eps_t = (t1 - t0) / (d - 1)
    eps_xi = (xi1 - xi0) / (m - 1)
    deg1 = max(degree(disc), 1)
    a_pt = complex(np.exp(2j * xi0 * eps_t / deg1))
    w_pt = complex(np.exp(2j * eps_xi * eps_t / deg1))
    pf = float(nse.phase_factor_rho(eps_t, t1, disc))

    def fn(qrh, qrl, qih, qil):
        q_cdf = ((qrh, qrl), (qih, qil))
        p = _tm_stage_df64(q_cdf, eps_t=eps_t, kappa=kappa, disc=disc)
        tm, _ = _tree_df64(p, n_true=d, deg_in=degree(disc),
                           want=((0, 0), (1, 0)), jsym=kappa)
        h11 = _chirpz_df64(_cdf_index(tm, (Ellipsis, 0, 0, slice(None))),
                           a_pt, w_pt, m)
        h21 = _chirpz_df64(_cdf_index(tm, (Ellipsis, 1, 0, slice(None))),
                           a_pt, w_pt, m)
        phase = _cdf_reg(
            ("df64_phase", m, xi0, xi1, pf),
            lambda: np.exp(1j * np.linspace(xi0, xi1, m) * pf))
        rho = cdf_div(cdf_mul(h21, phase), h11)
        return rho[0][0], rho[0][1], rho[1][0], rho[1][1]

    body = fn if batch is None else jax.vmap(fn)
    shape = (d,) if batch is None else (batch, d)
    ex = (jax.ShapeDtypeStruct(shape, jnp.float32),) * 4
    return tables.jit_tabled(body, ex)


def nsev_contspec_df64(q128, *, d: int, m: int, t_span, xi_span,
                       kappa: int = +1,
                       disc: Discretization = Discretization.SPLIT4B):
    """Reflection coefficient at reference accuracy in float32-pair ops.

    ``q128`` is complex128 (split at the boundary); every on-device
    operation is float32. Accepts a single signal [d] or a batch [b, d]
    (vmapped into the same program). Returns rho [..., m] complex128.
    """
    # split on the HOST (numpy): jnp.asarray would truncate complex128 to
    # complex64 whenever jax x64 is off (the float32 mode), zeroing every lo
    # plane and silently degrading the pipeline to f32 input accuracy
    q128 = np.asarray(q128, dtype=np.complex128)
    if d != q128.shape[-1]:
        raise ValueError(f"d={d} does not match signal length "
                         f"{q128.shape[-1]}")
    if d < 2 or d & (d - 1):
        raise ValueError("D must be a positive power of two")
    t_span = (float(t_span[0]), float(t_span[1]))
    xi_span = (float(xi_span[0]), float(xi_span[1]))
    # batching is handled INSIDE the core (eager per-row loop on CPU,
    # vmapped stages on accelerators) — do not vmap here
    num, h11 = _contspec_df64_core(cdf_from_c128(q128), d=d, m=m,
                                   t_span=t_span, xi_span=xi_span,
                                   kappa=kappa, disc=disc)
    # rho = num / h11: single complex128 divide at the host boundary
    return cdf_to_c128(num) / cdf_to_c128(h11)

# ---------------------------------------------------------------------------
# df64 bound states: Newton polish on the transfer-matrix polynomial
# ---------------------------------------------------------------------------

def _horner_pd_df64(coeffs, z):
    """(p(z), p'(z)) in cdf arithmetic; ascending coeffs [c], points [K].

    Bound-state z-points lie strictly inside the unit disk (Im lam > 0),
    so plain Horner is stable (reference fnft__poly_eval.c uses the
    reversed form only for |z| > 1).
    """
    from fnft_tpu.ops.df64 import _cdf_zeros_like

    zero = _cdf_zeros_like(z)

    def step(carry, ck):
        p, dp = carry
        dp = cdf_add(cdf_mul(dp, z), p)
        p = cdf_add(cdf_mul(p, z), ck)
        return (p, dp), None

    rev = jax.tree.map(lambda t: t[::-1], coeffs)
    (p, dp), _ = jax.lax.scan(step, (zero, zero), rev)
    return p, dp


@partial(jax.jit, static_argnames=("iters",))
def _polish_stage_df64(tm00, z0, iters: int = 3):
    from fnft_tpu.ops.df64 import cdf_div

    def body(k, z):
        p, dp = _horner_pd_df64(tm00, z)
        return cdf_sub(z, cdf_div(p, dp))

    return jax.lax.fori_loop(0, iters, body, z0)


def nsev_boundstates_df64(q128, *, d: int, t_span, kappa: int = +1,
                          disc: Discretization = Discretization.SPLIT4B,
                          initial_states=None, iters: int = 4):
    """Bound states at reference accuracy from float32-pair arithmetic.

    The discrete spectrum of the discretized system is exactly the set of
    a-polynomial roots in the upper-half-plane image; this routine builds
    the full-D transfer polynomial in df64 and Newton-polishes initial
    eigenvalue estimates (from the complex64 production pipeline unless
    supplied) against it. Covers the reference's FAST_EIGENVALUE +
    refinement semantics (fnft_nsev.c:595-741) in float32-pair precision.
    """
    if kappa != +1:
        raise ValueError("bound states require kappa=+1")
    q128 = np.asarray(q128, dtype=np.complex128)
    if d != q128.shape[-1]:
        raise ValueError(f"d={d} does not match signal length "
                         f"{q128.shape[-1]}")
    if d < 2 or d & (d - 1):
        raise ValueError("D must be a positive power of two")
    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / (d - 1)

    if initial_states is None:
        import fnft_tpu as ft

        res = ft.nsev(jnp.asarray(q128.astype(np.complex64)), (t0, t1),
                      m=0, kappa=+1,
                      opts=ft.NsevOpts(discretization=disc))
        initial_states = np.asarray(res.bound_states, dtype=np.complex128)
    lam0 = np.asarray(initial_states, dtype=np.complex128)
    if lam0.size == 0:
        return lam0

    q_cdf = cdf_from_c128(q128)
    p = _tm_stage_df64(q_cdf, eps_t=eps_t, kappa=kappa, disc=disc)
    tm, _ = _tree_stage_df64(p, n_true=d, deg_in=degree(disc),
                             want=((0, 0),), jsym=kappa)
    tm00 = _cdf_index(tm, (0, 0, slice(None)))

    from fnft_tpu.models.discretization import degree1step_total

    deg1 = degree1step_total(disc)
    z0 = np.exp(2j * lam0 * (eps_t / deg1))
    z = _polish_stage_df64(tm00, cdf_from_c128(z0), iters=iters)
    z128 = cdf_to_c128(z)
    return np.log(z128) * (deg1 / (2j * eps_t))


def kdvv_contspec_df64(u128, *, d: int, m: int, t_span, xi_span,
                       disc: Discretization = Discretization.SPLIT4B):
    """KdV reflection coefficient at reference accuracy (float32 pairs).

    r = -1 maps KdV onto the AKNS system (fnft__kdv_fscatter.c:75-76);
    the transfer matrix entries H12/H22 are chirp-evaluated on the
    negated xi grid in df64 and the KdV rho formula
    (fnft_kdvv.c:126-209) is applied on the host in float64 (the 2^w
    normalization cancels in the ratio).
    """
    u128 = np.asarray(u128, dtype=np.complex128)
    if d != u128.shape[-1]:
        raise ValueError(f"d={d} does not match signal length "
                         f"{u128.shape[-1]}")
    if d < 2 or d & (d - 1):
        raise ValueError("D must be a positive power of two")
    t0, t1 = float(t_span[0]), float(t_span[1])
    xi0, xi1 = float(xi_span[0]), float(xi_span[1])
    if not (t0 < t1 and xi0 < xi1 and m >= 2):
        raise ValueError("invalid grids (need T0 < T1, XI0 < XI1, M >= 2)")
    eps_t = (t1 - t0) / (d - 1)
    eps_xi = (xi1 - xi0) / (m - 1)
    deg1 = max(degree(disc), 1)

    u_cdf = cdf_from_c128(u128)
    ones = jnp.ones(d, jnp.float32)
    zeros = jnp.zeros(d, jnp.float32)
    r_cdf = ((-ones, zeros), (zeros, zeros))           # r = -1

    p = transfer_matrix_coeffs_df64(u_cdf, r_cdf, eps_t, disc)
    tm, _ = _tree_stage_df64(p, n_true=d, deg_in=degree(disc),
                             want=((0, 1), (1, 1)))

    a_pt = complex(np.exp(-2j * xi0 * eps_t / deg1))
    w_pt = complex(np.exp(-2j * eps_xi * eps_t / deg1))
    h12 = cdf_to_c128(_chirpz_df64(
        _cdf_index(tm, (0, 1, slice(None))), a_pt, w_pt, m))
    h22 = cdf_to_c128(_chirpz_df64(
        _cdf_index(tm, (1, 1, slice(None))), a_pt, w_pt, m))

    xi_neg = -(xi0 + eps_xi * np.arange(m))
    if disc is Discretization.SPLIT2A:
        h12 = h12 / np.exp(1j * xi_neg * (eps_t / deg1))
    num = np.exp(2j * xi_neg * (t1 + 0.5 * eps_t)) * h12
    den = 2j * xi_neg * h22 - h12
    return num / den


def kdvv_pipeline_df64_tabled(d: int, m: int, t_span, xi_span, *,
                              disc: Discretization = Discretization.SPLIT4B,
                              batch: int | None = None):
    """Memoized wrapper (same re-tracing cost note as the rho pipeline)."""
    return _kdvv_pipeline_df64_cached(d, m, (float(t_span[0]),
                                             float(t_span[1])),
                                      (float(xi_span[0]),
                                       float(xi_span[1])), disc, batch)


@lru_cache(maxsize=16)
def _kdvv_pipeline_df64_cached(d: int, m: int, t_span, xi_span,
                               disc: Discretization, batch: int | None):
    """KdV reflection coefficient as ONE jitted real-f32 program.

    The tabled (complex-free) twin of :func:`kdvv_contspec_df64`: takes
    the potential as four float32 hi/lo planes and returns rho's four
    planes, with the negated-grid chirp-Z and the KdV rho formula
    (fnft_kdvv.c:126-209; num = e^{2 i xi_n (T1 + eps/2)} H12,
    den = 2 i xi_n H22 - H12, xi_n = -xi) evaluated on-device in cdf
    arithmetic. The 2^w tree normalization cancels in the ratio. Every
    table (twiddles, chirp-Z spirals, phase/grid vectors) rides as a jit
    parameter via ops/tables.jit_tabled.
    """
    from fnft_tpu.ops import tables
    from fnft_tpu.ops.df64 import cdf_div

    t0, t1 = float(t_span[0]), float(t_span[1])
    xi0, xi1 = float(xi_span[0]), float(xi_span[1])
    if disc is Discretization.SPLIT2A:
        raise ValueError("tabled KdV pipeline: use SPLIT4B/SPLIT4A "
                         "(SPLIT2A needs the sqrt-z shift, kdvv.py)")
    eps_t = (t1 - t0) / (d - 1)
    eps_xi = (xi1 - xi0) / (m - 1)
    deg1 = max(degree(disc), 1)
    a_pt = complex(np.exp(-2j * xi0 * eps_t / deg1))
    w_pt = complex(np.exp(-2j * eps_xi * eps_t / deg1))

    def _xi_neg():
        return -(xi0 + eps_xi * np.arange(m, dtype=np.float64))

    def fn(urh, url, uih, uil):
        u_cdf = ((urh, url), (uih, uil))
        dd = urh.shape[-1]
        ones = jnp.ones(dd, jnp.float32)
        zeros = jnp.zeros(dd, jnp.float32)
        r_cdf = ((-ones, zeros), (zeros, zeros))          # r = -1
        p = transfer_matrix_coeffs_df64(u_cdf, r_cdf, eps_t, disc)
        tm, _ = _tree_df64(p, n_true=d, deg_in=degree(disc),
                           want=((0, 1), (1, 1)))
        h12 = _chirpz_df64(_cdf_index(tm, (Ellipsis, 0, 1, slice(None))),
                           a_pt, w_pt, m)
        h22 = _chirpz_df64(_cdf_index(tm, (Ellipsis, 1, 1, slice(None))),
                           a_pt, w_pt, m)
        phase = _cdf_reg(
            ("df64_kdv_phase", m, xi0, xi1, t1, eps_t),
            lambda: np.exp(2j * _xi_neg() * (t1 + 0.5 * eps_t)))
        two_i_xi = _cdf_reg(("df64_kdv_2ixi", m, xi0, xi1),
                            lambda: 2j * _xi_neg())
        num = cdf_mul(phase, h12)
        den = cdf_sub(cdf_mul(two_i_xi, h22), h12)
        rho = cdf_div(num, den)
        return rho[0][0], rho[0][1], rho[1][0], rho[1][1]

    body = fn if batch is None else jax.vmap(fn)
    shape = (d,) if batch is None else (batch, d)
    ex = (jax.ShapeDtypeStruct(shape, jnp.float32),) * 4
    return tables.jit_tabled(body, ex)


def kdvv_pipeline_df64_staged(d: int, m: int, t_span, xi_span, *,
                              disc: Discretization = Discretization.SPLIT8B):
    """Two-program KdV pipeline for large geometries.

    The one-program :func:`kdvv_pipeline_df64_tabled` at the C-anchor
    config (2SPLIT8B, D=M=2^17) makes one very large compile. Splitting at
    the transfer-matrix boundary keeps each program's compile bounded; the
    intermediate tm planes stay on device between the two jitted calls.
    """
    return _kdvv_staged_cached(d, m, (float(t_span[0]), float(t_span[1])),
                               (float(xi_span[0]), float(xi_span[1])), disc)


@lru_cache(maxsize=8)
def _kdvv_staged_cached(d: int, m: int, t_span, xi_span,
                        disc: Discretization):
    from fnft_tpu.ops import tables
    from fnft_tpu.ops.df64 import cdf_div

    t0, t1 = t_span
    xi0, xi1 = xi_span
    eps_t = (t1 - t0) / (d - 1)
    eps_xi = (xi1 - xi0) / (m - 1)
    deg1 = max(degree(disc), 1)
    a_pt = complex(np.exp(-2j * xi0 * eps_t / deg1))
    w_pt = complex(np.exp(-2j * eps_xi * eps_t / deg1))
    deg_total = degree(disc) * d

    def stage_a(urh, url, uih, uil):
        u_cdf = ((urh, url), (uih, uil))
        ones = jnp.ones(d, jnp.float32)
        zeros = jnp.zeros(d, jnp.float32)
        r_cdf = ((-ones, zeros), (zeros, zeros))          # r = -1
        p = transfer_matrix_coeffs_df64(u_cdf, r_cdf, eps_t, disc)
        tm, _ = _tree_df64(p, n_true=d, deg_in=degree(disc),
                           want=((0, 1), (1, 1)))
        c12 = _cdf_index(tm, (Ellipsis, 0, 1, slice(None)))
        c22 = _cdf_index(tm, (Ellipsis, 1, 1, slice(None)))
        return (c12[0][0], c12[0][1], c12[1][0], c12[1][1],
                c22[0][0], c22[0][1], c22[1][0], c22[1][1])

    def _xi_neg():
        return -(xi0 + eps_xi * np.arange(m, dtype=np.float64))

    def stage_b(*planes):
        h12c = ((planes[0], planes[1]), (planes[2], planes[3]))
        h22c = ((planes[4], planes[5]), (planes[6], planes[7]))
        h12 = _chirpz_df64(h12c, a_pt, w_pt, m)
        h22 = _chirpz_df64(h22c, a_pt, w_pt, m)
        phase = _cdf_reg(
            ("df64_kdv_phase", m, xi0, xi1, t1, eps_t),
            lambda: np.exp(2j * _xi_neg() * (t1 + 0.5 * eps_t)))
        two_i_xi = _cdf_reg(("df64_kdv_2ixi", m, xi0, xi1),
                            lambda: 2j * _xi_neg())
        num = cdf_mul(phase, h12)
        den = cdf_sub(cdf_mul(two_i_xi, h22), h12)
        rho = cdf_div(num, den)
        return rho[0][0], rho[0][1], rho[1][0], rho[1][1]

    ex_a = (jax.ShapeDtypeStruct((d,), jnp.float32),) * 4
    fa = tables.jit_tabled(stage_a, ex_a)
    ex_b = (jax.ShapeDtypeStruct((deg_total + 1,), jnp.float32),) * 8
    fb = tables.jit_tabled(stage_b, ex_b)

    def run(urh, url, uih, uil):
        return fb(*fa(urh, url, uih, uil))

    return run


def nsev_boundstates_df64_batched(q128_batch, *, d: int, t_span,
                                  kappa: int = +1,
                                  disc: Discretization = Discretization.SPLIT4B,
                                  initial_states=None, k_max: int = 0,
                                  iters: int = 4):
    """Batched df64 bound states: [B, D] -> (lam [B, k_max], mask).

    Per-signal eigenvalue counts differ, so results are padded to
    ``k_max`` (auto = the largest count) with a validity mask; the df64
    transfer polynomials and the Newton polish run as one vmapped
    program over the batch.
    """
    if kappa != +1:
        raise ValueError("bound states require kappa=+1")
    qb = np.asarray(q128_batch, dtype=np.complex128)
    b, dd = qb.shape
    if d != dd:
        raise ValueError(f"d={d} does not match signal length {dd}")
    if d < 2 or d & (d - 1):
        raise ValueError("D must be a positive power of two")
    t0, t1 = float(t_span[0]), float(t_span[1])
    eps_t = (t1 - t0) / (d - 1)

    if initial_states is None:
        import fnft_tpu as ft

        initial_states = []
        for i in range(b):
            res = ft.nsev(jnp.asarray(qb[i].astype(np.complex64)), (t0, t1),
                          m=0, kappa=+1,
                          opts=ft.NsevOpts(discretization=disc))
            initial_states.append(np.asarray(res.bound_states,
                                             dtype=np.complex128))
    counts = [len(s) for s in initial_states]
    k_max = k_max or max(counts + [1])
    lam0 = np.zeros((b, k_max), np.complex128)
    mask = np.zeros((b, k_max), bool)
    for i, s in enumerate(initial_states):
        k = min(len(s), k_max)
        lam0[i, :k] = s[:k]
        mask[i, :k] = True
    lam0[~mask] = 1j  # benign placeholder inside the unit-disk image

    from fnft_tpu.models.discretization import degree1step_total

    deg1 = degree1step_total(disc)
    z0 = np.exp(2j * lam0 * (eps_t / deg1))

    def one(q_cdf, z0_cdf):
        p = _tm_stage_df64(q_cdf, eps_t=eps_t, kappa=kappa, disc=disc)
        tm, _ = _tree_stage_df64(p, n_true=d, deg_in=degree(disc),
                                 want=((0, 0),), jsym=kappa)
        tm00 = _cdf_index(tm, (0, 0, slice(None)))
        return _polish_stage_df64(tm00, z0_cdf, iters=iters)

    z = jax.vmap(one)(cdf_from_c128(qb), cdf_from_c128(z0))
    lam = np.log(np.asarray(cdf_to_c128(z))) * (deg1 / (2j * eps_t))
    lam[~mask] = 0.0
    return lam, mask
