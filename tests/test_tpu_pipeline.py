"""Real-pair lowered pipeline (ops/tpu_pipeline) vs the complex pipeline.

The lowered pipeline is for backends without complex types; on CPU it
must agree with the complex c64 flagship pipeline
(__graft_entry__._rho_pipeline) to f32 accuracy.  Amplitudes are chosen
away from integers: A in Z makes sech reflectionless (rho == 0 up to
noise), where relative comparisons are meaningless.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import __graft_entry__ as ge
from fnft_tpu.ops import rc
from fnft_tpu.ops.mxu_fft import fft_pair, ifft_pair
from fnft_tpu.ops.tpu_pipeline import chirpz_rc, rho_pipeline_rc
from fnft_tpu.ops.poly import chirpz

D, M = 1024, 1024
T_SPAN, XI_SPAN = (-25.0, 25.0), (-2.0, 2.0)


@pytest.fixture(scope="module")
def pipelines():
    return (jax.jit(ge._rho_pipeline(D, M, T_SPAN, XI_SPAN)),
            jax.jit(rho_pipeline_rc(D, M, T_SPAN, XI_SPAN)))


def _sech(amp):
    t = np.linspace(*T_SPAN, D)
    return (1j * amp / np.cosh(t)).astype(np.complex64)


def test_mxu_fft_roundtrip():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((3, 4096))
         + 1j * rng.standard_normal((3, 4096))).astype(np.complex64)
    p = rc.from_complex(x)
    f = fft_pair(p)
    ref = np.fft.fft(x, axis=-1)
    got = np.asarray(f[0]) + 1j * np.asarray(f[1])
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 2e-6
    b = ifft_pair(f)
    back = np.asarray(b[0]) + 1j * np.asarray(b[1])
    assert np.max(np.abs(back - x)) < 2e-6 * np.max(np.abs(x))


def test_chirpz_rc_matches_complex():
    rng = np.random.default_rng(0)
    c = (rng.standard_normal((2, 513))
         + 1j * rng.standard_normal((2, 513))).astype(np.complex64)
    a_pt = complex(np.exp(-0.2j))
    w_pt = complex(np.exp(0.002j))
    ref = np.asarray(chirpz(jnp.asarray(c), a_pt, w_pt, 256))
    got = chirpz_rc(rc.from_complex(c), a_pt, w_pt, 256)
    g = np.asarray(got[0]) + 1j * np.asarray(got[1])
    assert np.max(np.abs(g - ref)) / np.max(np.abs(ref)) < 1e-5


@pytest.mark.parametrize("amp", [1.5, 2.5, 3.2])
def test_rho_matches_complex_pipeline(pipelines, amp):
    rho_c, rho_r = pipelines
    q = _sech(amp)
    ref = np.asarray(rho_c(q[None]))[0]
    rr, ri = rho_r(jnp.asarray(q.real), jnp.asarray(q.imag))
    got = np.asarray(rr) + 1j * np.asarray(ri)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 5e-4


def test_rho_batched_matches_unbatched(pipelines):
    _, rho_r = pipelines
    qs = np.stack([_sech(a) for a in (1.3, 1.5, 2.2, 3.2)])
    br, bi = rho_r(jnp.asarray(qs.real), jnp.asarray(qs.imag))
    for k in range(qs.shape[0]):
        ur, ui = rho_r(jnp.asarray(qs[k].real), jnp.asarray(qs[k].imag))
        u = np.asarray(ur) + 1j * np.asarray(ui)
        b = (np.asarray(br) + 1j * np.asarray(bi))[k]
        assert np.max(np.abs(u - b)) / (np.max(np.abs(b)) + 1e-30) < 1e-4


def test_tabled_matches_inline(pipelines):
    """jit_tabled (tables as device params) == plain jit (inline consts)."""
    from fnft_tpu.ops.tpu_pipeline import rho_pipeline_tabled

    _, rho_r = pipelines
    q = _sech(3.2)
    tabled = rho_pipeline_tabled(D, M, T_SPAN, XI_SPAN)
    assert tabled.n_tables > 0 and tabled.table_bytes > 0
    tr, ti = tabled(jnp.asarray(q.real), jnp.asarray(q.imag))
    ir, ii = rho_r(jnp.asarray(q.real), jnp.asarray(q.imag))
    gt = np.asarray(tr) + 1j * np.asarray(ti)
    gi = np.asarray(ir) + 1j * np.asarray(ii)
    assert np.max(np.abs(gt - gi)) / np.max(np.abs(gi)) < 1e-6


def test_rho_defocusing_runs():
    # kappa=-1 path (cosh branch): finite and consistent across ranks
    rho_r = jax.jit(rho_pipeline_rc(D, M, T_SPAN, XI_SPAN, kappa=-1))
    q = _sech(0.9)
    rr, ri = rho_r(jnp.asarray(q.real), jnp.asarray(q.imag))
    assert np.all(np.isfinite(np.asarray(rr)))
    assert np.all(np.isfinite(np.asarray(ri)))
