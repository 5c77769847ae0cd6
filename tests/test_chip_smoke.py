"""CPU rehearsal of chip_smoke.py and the helpers it relies on.

Each phase's run-and-compare function runs here at a tiny size and must
meet its own bound; timings from this backend mean nothing and are not
checked. The multi-device phases run on four of the virtual CPU devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from fnft_tpu import config
from fnft_tpu.utils.device import NoGpuError, require_gpu


@pytest.mark.parametrize("name", list(chip_smoke.PHASES)
                         + list(chip_smoke.MULTI_PHASES))
def test_phase_rehearsal(name):
    table = {**chip_smoke.PHASES, **chip_smoke.MULTI_PHASES}
    builder, _, tiny = table[name]
    rec = chip_smoke.measure(name, builder, tiny, reps=0)
    assert rec["errors"] and set(rec["errors"]) == set(rec["bounds"])
    assert rec["failed"] == [], rec


def test_scaled_bound_rule():
    assert chip_smoke.scaled_bound(3.9e-6, 4096) == 3.9e-6
    assert chip_smoke.scaled_bound(3.9e-6, 8192) == pytest.approx(9.75e-7)
    assert chip_smoke.scaled_bound(3.9e-6, 1 << 20) == 1e-8   # roundoff floor
    assert chip_smoke.nsev_full_bounds(4096) == chip_smoke.NSEV_BOUNDS_4096


def test_repulsion_oracle_excludes_self():
    z = np.array([0.0, 1.0, 1j])
    want = np.array([1 / (0 - 1) + 1 / (0 - 1j), 1 / (1 - 0) + 1 / (1 - 1j),
                     1 / (1j - 0) + 1 / (1j - 1)])
    np.testing.assert_allclose(chip_smoke.repulsion_oracle(z, block=2), want)


def test_require_gpu_raises_on_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(NoGpuError, match="GPU is required"):
        require_gpu()


def test_smoke_main_refuses_cpu(capsys):
    with pytest.raises(NoGpuError):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_compilation_cache_dir_from_env(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert config.compilation_cache_dir() == "/elsewhere/cache"
    assert config.enable_compilation_cache() == "/elsewhere/cache"
    assert calls == []          # JAX reads the variable itself


def test_compilation_cache_dir_default(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(config._CHECKOUT / ".jax_cache")
    assert config._CHECKOUT.joinpath("fnft_tpu", "config.py").is_file()
    assert config.enable_compilation_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]


def _dot_precisions(fn, *args):
    text = jax.jit(fn).lower(*args).as_text()
    lines = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert lines, "no matrix product lowered"
    return lines


def _block_horner_ratio(z):
    from fnft_tpu.ops.roots import _block_eval_ratio
    coeffs = jnp.arange(1, 200, dtype=jnp.float32).astype(jnp.complex64)
    return _block_eval_ratio(coeffs, z)


def _block_horner_residuals(z):
    from fnft_tpu.ops.roots import root_residuals
    coeffs = jnp.arange(1, 200, dtype=jnp.float32).astype(jnp.complex64)
    return root_residuals(coeffs, z)


def _real_pair_ratio(z):
    from fnft_tpu.ops.tpu_roots import _block_eval_ratio_rc
    c = jnp.arange(1, 200, dtype=jnp.float32)
    return _block_eval_ratio_rc((c, 0 * c), (jnp.real(z), jnp.imag(z)))


@pytest.mark.parametrize("fn", [_block_horner_ratio, _block_horner_residuals,
                                _real_pair_ratio],
                         ids=["block_eval_ratio", "root_residuals",
                              "real_pair_matmul"])
def test_float32_products_ask_for_highest(fn):
    """complex64/float32 block-Horner products must not run in TF32."""
    z = jnp.linspace(0.1, 0.9, 16).astype(jnp.complex64)
    for ln in _dot_precisions(fn, z):
        assert "HIGHEST" in ln, ln


@pytest.mark.parametrize("entry", ["nsev_fullspec_tpu", "df64.nsev_contspec",
                                   "rho_pipeline_tabled"])
def test_complex_free_tier_refuses_gpu(monkeypatch, entry):
    """The float32-pair tier raises its named error on a GPU backend
    instead of running (checked here by faking the backend name)."""
    import fnft_tpu as ft
    from fnft_tpu import df64
    from fnft_tpu.errors import ComplexFreeTierUnavailableError
    from fnft_tpu.ops.tpu_pipeline import rho_pipeline_tabled

    q = np.ones(64, complex)
    call = {
        "nsev_fullspec_tpu": lambda: ft.nsev_fullspec_tpu(q, (-1.0, 1.0)),
        "df64.nsev_contspec": lambda: df64.nsev_contspec(
            q, d=64, m=64, t_span=(-1.0, 1.0), xi_span=(-2.0, 2.0)),
        "rho_pipeline_tabled": lambda: rho_pipeline_tabled(
            64, 64, (-1.0, 1.0), (-2.0, 2.0)),
    }[entry]
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(ComplexFreeTierUnavailableError, match="complex128"):
        call()
