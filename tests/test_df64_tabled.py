"""df64 table-registry integration: the twiddle/chirp-Z/phase tables must
produce identical results whether inlined as literals (plain jit / eager,
the CPU mode) or passed as jit parameters (tables.jit_tabled, the
accelerator mode). Here the mechanism is validated at small sizes (XLA:CPU compiles of the deep df64 chains are minutes-slow,
see ops/df64_pipeline.py's staging note)."""

import numpy as np
import jax
import jax.numpy as jnp

from fnft_tpu.ops import tables
from fnft_tpu.ops.df64 import _fft_df64, cdf_from_c128, cdf_to_c128
from fnft_tpu.ops.df64_pipeline import _chirpz_df64


def _cdf_planes(z):
    re, im = np.real(z), np.imag(z)
    rh = re.astype(np.float32)
    rl = (re - rh.astype(np.float64)).astype(np.float32)
    ih = im.astype(np.float32)
    il = (im - ih.astype(np.float64)).astype(np.float32)
    return rh, rl, ih, il


def _join(o):
    return (np.asarray(o[0], np.float64) + np.asarray(o[1], np.float64)) \
        + 1j * (np.asarray(o[2], np.float64) + np.asarray(o[3], np.float64))


def test_fft_df64_tabled_matches_inline():
    rng = np.random.default_rng(0)
    for n in (96, 256):  # radix-3*2^k and four-step/pow2 paths
        z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        ref = np.fft.fft(z)

        def body(rh, rl, ih, il):
            out = _fft_df64(((rh, rl), (ih, il)), n)
            return out[0][0], out[0][1], out[1][0], out[1][1]

        ex = (jax.ShapeDtypeStruct((n,), jnp.float32),) * 4
        fn = tables.jit_tabled(body, ex)
        assert fn.n_tables > 0  # twiddles actually ride as parameters
        got = _join(fn(*_cdf_planes(z)))
        np.testing.assert_allclose(got, ref, atol=1e-12 * np.max(np.abs(ref)))


def test_chirpz_df64_tabled_matches_eager():
    rng = np.random.default_rng(1)
    n, m = 129, 64
    a_pt = complex(np.exp(0.11j))
    w_pt = complex(np.exp(-0.013j))
    z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    eager = np.asarray(cdf_to_c128(_chirpz_df64(cdf_from_c128(z),
                                                a_pt, w_pt, m)))
    # reference: direct evaluation p(a w^k)
    pts = a_pt * w_pt ** np.arange(m)
    ref = np.polyval(z[::-1], pts)
    np.testing.assert_allclose(eager, ref, atol=1e-11 * np.max(np.abs(ref)))

    def body(rh, rl, ih, il):
        out = _chirpz_df64(((rh, rl), (ih, il)), a_pt, w_pt, m)
        return out[0][0], out[0][1], out[1][0], out[1][1]

    ex = (jax.ShapeDtypeStruct((n,), jnp.float32),) * 4
    fn = tables.jit_tabled(body, ex)
    assert fn.n_tables >= 3  # xw, vf, wout
    got = _join(fn(*_cdf_planes(z)))
    np.testing.assert_allclose(got, eager, atol=1e-12 * np.max(np.abs(ref)))


def test_rho_pipeline_df64_params_path():
    """Full pipeline body with tables as parameters vs the staged CPU path.

    Runs the tabled body EAGERLY with the registry in params mode: jitting
    the whole df64 program trips XLA:CPU's minutes-long slow-compile alarm
    even at D=64 (the staged CPU driver exists for exactly this reason).
    The eager params run still proves the collection pass finds every table
    and the param hand-off returns identical values to the inline path.
    """
    from fnft_tpu.models import nse
    from fnft_tpu.models.discretization import Discretization, degree
    from fnft_tpu.ops.df64 import _cdf_index, cdf_div, cdf_mul
    from fnft_tpu.ops.df64_pipeline import (_chirpz_df64, _cdf_reg,
                                            _tm_stage_df64, _tree_df64,
                                            nsev_contspec_df64)

    d = m = 128
    t_span, xi_span = (-12.0, 12.0), (-1.0, 1.0)
    t = np.linspace(*t_span, d)
    q = (1.1j / np.cosh(t)).astype(np.complex128)
    ref = np.asarray(nsev_contspec_df64(q, d=d, m=m, t_span=t_span,
                                        xi_span=xi_span))

    disc = Discretization.SPLIT4B
    eps_t = (t_span[1] - t_span[0]) / (d - 1)
    eps_xi = (xi_span[1] - xi_span[0]) / (m - 1)
    deg1 = max(degree(disc), 1)
    a_pt = complex(np.exp(2j * xi_span[0] * eps_t / deg1))
    w_pt = complex(np.exp(2j * eps_xi * eps_t / deg1))
    pf = float(nse.phase_factor_rho(eps_t, t_span[1], disc))

    def body(qrh, qrl, qih, qil):
        q_cdf = ((qrh, qrl), (qih, qil))
        p = _tm_stage_df64(q_cdf, eps_t=eps_t, kappa=1, disc=disc)
        tm, _ = _tree_df64(p, n_true=d, deg_in=degree(disc),
                           want=((0, 0), (1, 0)), jsym=1)
        h11 = _chirpz_df64(_cdf_index(tm, (0, 0, slice(None))),
                           a_pt, w_pt, m)
        h21 = _chirpz_df64(_cdf_index(tm, (1, 0, slice(None))),
                           a_pt, w_pt, m)
        phase = _cdf_reg(
            ("df64_phase", m, xi_span[0], xi_span[1], pf),
            lambda: np.exp(1j * np.linspace(*xi_span, m) * pf))
        rho = cdf_div(cdf_mul(h21, phase), h11)
        return rho[0][0], rho[0][1], rho[1][0], rho[1][1]

    planes = [jnp.asarray(a) for a in _cdf_planes(q)]
    ex = tuple(jax.ShapeDtypeStruct((d,), jnp.float32) for _ in range(4))
    collect = {}
    with tables._Ctx("collect", collect):
        jax.eval_shape(body, *ex)
    assert collect, "collection pass found no tables"
    params = {k: tuple(jnp.asarray(a) for a in v)
              for k, v in collect.items()}
    with tables._Ctx("params", params):
        out = body(*planes)
    got = _join(out)
    np.testing.assert_allclose(got, ref, atol=1e-11 * np.max(np.abs(ref)))
