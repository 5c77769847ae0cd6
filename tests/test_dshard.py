"""D-axis (time) sharding of the fast NFT: equivalence + work partitioning.

The reference's poly_fmult tree is sequential C (fnft__poly_fmult.c:381-546);
here its first log2(D/S) levels run shard-local and the last log2(S) levels
are replaced by a value-space butterfly over cross-device collectives. These tests
run on the 8-virtual-device CPU mesh from conftest.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fnft_tpu.models.discretization import Discretization
from fnft_tpu.models.nsev import ContspecType
from fnft_tpu.parallel.dshard import (
    dshard_contspec_reference,
    make_dshard_contspec,
    make_gridsharded_chirpz,
)
from fnft_tpu.parallel.sharding import batched_nsev_contspec, make_mesh
from fnft_tpu.ops.poly import chirpz

D, M = 2048, 512
T_SPAN, XI_SPAN = (-16.0, 16.0), (-1.5, 1.5)


def _sech(d, amp=3.2):
    t = np.linspace(*T_SPAN, d)
    return (1j * amp / np.cosh(t)).astype(np.complex128)


@pytest.fixture(scope="module")
def seq_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(axis_names=("seq",))


def test_dshard_matches_unsharded(seq_mesh):
    q = _sech(D)
    fn = make_dshard_contspec(D, T_SPAN, M, XI_SPAN, seq_mesh)
    rho_sharded = np.asarray(fn(q)["rho"])
    rho_ref = np.asarray(batched_nsev_contspec(q[None], T_SPAN, M, XI_SPAN))[0]
    assert rho_sharded.shape == (M,)
    np.testing.assert_allclose(rho_sharded, rho_ref, rtol=0, atol=1e-11)


def test_dshard_matches_singledevice_replica(seq_mesh):
    """The sharded program does the same floating-point work as the
    reshape-based single-device replica."""
    q = _sech(D)
    fn = make_dshard_contspec(D, T_SPAN, M, XI_SPAN, seq_mesh)
    rho_sharded = np.asarray(fn(q)["rho"])
    rho_replica = np.asarray(
        dshard_contspec_reference(q, D, T_SPAN, M, XI_SPAN, s=8)["rho"])
    np.testing.assert_allclose(rho_sharded, rho_replica, rtol=0, atol=1e-13)


def test_dshard_ab_normalization(seq_mesh):
    """a/b need the summed 2^W exponent across shards — checks the fold's
    w bookkeeping, not just the scale-free rho ratio."""
    q = _sech(D)
    fn = make_dshard_contspec(D, T_SPAN, M, XI_SPAN, seq_mesh,
                              contspec_type=ContspecType.AB)
    out = fn(q)
    ref = dshard_contspec_reference(q, D, T_SPAN, M, XI_SPAN, s=8,
                                    contspec_type=ContspecType.AB)
    np.testing.assert_allclose(np.asarray(out["a"]), np.asarray(ref["a"]),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(np.asarray(out["b"]), np.asarray(ref["b"]),
                               rtol=0, atol=1e-11)
    # unitarity-like sanity on the focusing case: |a|^2 + |b|^2 = 1
    mod = np.abs(np.asarray(out["a"])) ** 2 + np.abs(np.asarray(out["b"])) ** 2
    np.testing.assert_allclose(mod, 1.0, atol=1e-6)


@pytest.mark.parametrize("disc", [Discretization.SPLIT4A4,
                                  Discretization.SPLIT4B4])
def test_dshard_upsampled_schemes(seq_mesh, disc):
    """4SPLIT4A/B (upsampling factor 2, CF4_2 stages): the sharded path
    gathers q once for the stage resample, then stays sharded."""
    q = _sech(D)
    fn = make_dshard_contspec(D, T_SPAN, M, XI_SPAN, seq_mesh, disc=disc)
    rho_sharded = np.asarray(fn(q)["rho"])
    rho_ref = np.asarray(batched_nsev_contspec(q[None], T_SPAN, M, XI_SPAN,
                                               disc=disc))[0]
    assert rho_sharded.shape == (M,)
    np.testing.assert_allclose(rho_sharded, rho_ref, rtol=0, atol=1e-11)
    rho_replica = np.asarray(dshard_contspec_reference(
        q, D, T_SPAN, M, XI_SPAN, s=8, disc=disc)["rho"])
    np.testing.assert_allclose(rho_sharded, rho_replica, rtol=0, atol=1e-13)


def test_dshard_batched(seq_mesh):
    """(data, seq) mesh: batch and time sharded simultaneously."""
    mesh = make_mesh(axis_names=("data", "seq"))
    if mesh.shape["seq"] < 2:
        pytest.skip("needs a 2d mesh")
    q = np.stack([_sech(D, amp) for amp in (1.0, 2.0, 3.2, 4.1)])
    fn = make_dshard_contspec(D, T_SPAN, M, XI_SPAN, mesh,
                              batch_axis="data")
    rho = np.asarray(fn(q)["rho"])
    ref = np.asarray(batched_nsev_contspec(q, T_SPAN, M, XI_SPAN))
    np.testing.assert_allclose(rho, ref, rtol=0, atol=1e-11)


def test_dshard_per_device_flops_drop(seq_mesh):
    """Each device must do ~1/S of the tree work: per-device FLOPs of the
    sharded program must be well below the unsharded program's."""
    q = jnp.asarray(_sech(D))
    fn = make_dshard_contspec(D, T_SPAN, M, XI_SPAN, seq_mesh)
    q_sh = jax.device_put(q, fn.in_sharding)
    sharded_cost = fn.sharded_fn.lower(q_sh).compile().cost_analysis()

    def unsharded(qq):
        return batched_nsev_contspec(qq[None], T_SPAN, M, XI_SPAN)

    base_cost = jax.jit(unsharded).lower(q).compile().cost_analysis()
    f_sh, f_un = sharded_cost.get("flops", 0.0), base_cost.get("flops", 0.0)
    assert f_un > 0 and f_sh > 0
    # tree shards 8x; the chirp-Z eval phase evaluates 4 (not 2) entries of
    # an 8x-shorter polynomial, so the overall drop lands between 2x and 8x
    assert f_sh < f_un / 2.0, (f_sh, f_un)


def test_gridsharded_chirpz(seq_mesh):
    rng = np.random.default_rng(7)
    n, m = 64, 512
    coeffs = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    a = complex(np.exp(0.3j))
    w = complex(np.exp(2j * np.pi / m * 0.9))
    fn = make_gridsharded_chirpz(n, a, w, m, seq_mesh)
    got = np.asarray(fn(jnp.asarray(coeffs)))
    want = np.asarray(chirpz(jnp.asarray(coeffs), a, w, m))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_gridsharded_chirpz_batched(seq_mesh):
    rng = np.random.default_rng(11)
    n, m, b = 48, 256, 3
    coeffs = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    a = complex(np.exp(-0.1j))
    w = complex(np.exp(2j * np.pi / m))
    fn = make_gridsharded_chirpz(n, a, w, m, seq_mesh, nlead=1)
    got = np.asarray(fn(jnp.asarray(coeffs)))
    want = np.asarray(chirpz(jnp.asarray(coeffs), a, w, m))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("disc", [Discretization.SPLIT8B,
                                  Discretization.SPLIT2A])
def test_dshard_kdvv_matches_driver(seq_mesh, disc):
    """D-sharded KdV contspec == the kdvv driver (real potential, rsym
    local trees, negated-grid chirp-Z; reference fnft_kdvv.c:129-204)."""
    import fnft_tpu as ft
    from fnft_tpu.models.kdvv import KdvvOpts
    from fnft_tpu.parallel.dshard import make_dshard_kdvv_contspec

    d, m = 1024, 256
    t_span, xi_span = (-16.0, 15.0), (-2.05, 2.15)
    t = np.linspace(*t_span, d)
    u = (3.2 / np.cosh(t) ** 2).astype(np.float64)

    fn = make_dshard_kdvv_contspec(d, t_span, m, xi_span, seq_mesh,
                                   disc=disc)
    rho_sh = np.asarray(fn(u)["rho"])
    ref = ft.kdvv(jnp.asarray(u), t_span, m=m, xi_span=xi_span,
                  opts=KdvvOpts(discretization=disc))
    rho_ref = np.asarray(ref.reflection_coefficient)
    assert rho_sh.shape == (m,)
    scale = np.max(np.abs(rho_ref))
    np.testing.assert_allclose(rho_sh, rho_ref, rtol=0, atol=1e-11 * scale)


def test_dshard_kdvv_batched(seq_mesh):
    import fnft_tpu as ft
    from fnft_tpu.parallel.dshard import make_dshard_kdvv_contspec

    d, m = 512, 128
    t_span, xi_span = (-12.0, 12.0), (-1.5, 1.5)
    t = np.linspace(*t_span, d)
    mesh = make_mesh(axis_names=("data", "seq"))  # (4, 2) over 8
    us = np.stack([a / np.cosh(t) ** 2 for a in (1.1, 2.3, 0.7, 3.0)])
    fn = make_dshard_kdvv_contspec(d, t_span, m, xi_span, mesh,
                                   batch_axis="data")
    rho = np.asarray(fn(us)["rho"])
    assert rho.shape == (4, m)
    for i in range(4):
        ref = ft.kdvv(jnp.asarray(us[i]), t_span, m=m, xi_span=xi_span)
        np.testing.assert_allclose(
            rho[i], np.asarray(ref.reflection_coefficient),
            rtol=0, atol=1e-11 * float(np.max(np.abs(np.asarray(
                ref.reflection_coefficient)))))
