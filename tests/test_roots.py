"""Rootfinder stress tests (the eiscor-replacement reliability claim).

Acceptance is residual-based (backward error): for ill-conditioned
polynomials two backward-stable solvers legitimately disagree by
cond*eps, so |p(root)| is the honest metric. LAPACK's companion QR
(numpy.roots) serves as the comparison point.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from fnft_tpu.ops.roots import poly_roots


def _cases():
    rng = np.random.default_rng(42)
    out = []
    for trial in range(8):
        deg = int(rng.integers(5, 120))
        kind = trial % 4
        if kind == 0:
            c = rng.normal(size=deg + 1) + 1j * rng.normal(size=deg + 1)
        elif kind == 1:  # 16 orders of magnitude dynamic range
            c = (rng.normal(size=deg + 1) + 1j * rng.normal(size=deg + 1)) \
                * 10.0 ** rng.integers(-8, 8, size=deg + 1)
        elif kind == 2:  # clustered near the unit circle (monodromy-like)
            roots = np.exp(1j * rng.uniform(0, 2 * np.pi, deg)) \
                * (1 + 0.01 * rng.normal(size=deg))
            c = np.poly(roots)[::-1]
        else:            # a double root among random ones
            r0 = rng.normal() + 1j * rng.normal()
            roots = np.concatenate(
                [[r0, r0], rng.normal(size=deg - 2) + 1j * rng.normal(size=deg - 2)])
            c = np.poly(roots)[::-1]
        out.append((trial, kind, c))
    return out


def _norm_residual(c, z):
    """|p(z)| / sum_k |c_k z^k| computed in log space (overflow-safe)."""
    k = np.arange(len(c))
    with np.errstate(divide="ignore"):
        logs = np.log(np.abs(c))[None, :] + k[None, :] * \
            np.log(np.maximum(np.abs(z), 1e-300))[:, None]
    m = logs.max(axis=1, keepdims=True)
    terms = np.exp(logs - m) * np.exp(1j * (np.angle(c)[None, :]
                                            + k[None, :] * np.angle(z)[:, None]))
    return np.max(np.abs(terms.sum(axis=1)) / np.abs(np.abs(terms).sum(axis=1)))


@pytest.mark.parametrize("trial,kind,c", _cases(),
                         ids=[f"t{t}k{k}" for t, k, _ in _cases()])
def test_aberth_backward_error_vs_lapack(trial, kind, c):
    got = np.asarray(poly_roots(jnp.asarray(c)))
    lapack = np.roots(c[::-1])
    res_mine = _norm_residual(c, got)
    res_lapack = _norm_residual(c, lapack)
    # at least as backward-stable as LAPACK (small atol for exact zeros)
    assert res_mine <= 20.0 * res_lapack + 1e-12, (res_mine, res_lapack)
    # and the root count is exact
    assert got.shape[0] == len(c) - 1


def test_aberth_known_roots():
    """Well-conditioned case: match the constructed roots directly."""
    rng = np.random.default_rng(3)
    roots = rng.normal(size=12) + 1j * rng.normal(size=12)
    c = np.poly(roots)[::-1] * (2.0 - 1.5j)
    got = np.sort_complex(np.asarray(poly_roots(jnp.asarray(c))))
    np.testing.assert_allclose(got, np.sort_complex(roots), atol=1e-9)


def test_root_residuals_finite_in_complex64():
    """The underflow guard must use the working dtype's tiny: float64's
    tiny underflows to 0 in float32, which turned the residual at an
    exact root z=0 of a zero-constant-coefficient polynomial into 0/0."""
    from fnft_tpu.ops.roots import root_residuals

    # p(z) = z (z - 1) (z - 2): ascending coefficients, c0 == 0
    coeffs = jnp.asarray([0.0, 2.0, -3.0, 1.0], dtype=jnp.complex64)
    eta = np.asarray(root_residuals(coeffs, jnp.asarray([0j], jnp.complex64)))
    assert np.isfinite(eta).all(), eta
    assert eta[0] < 1e-6, eta


def _repulsion_oracle(z_all, z_t, idx):
    """Direct O(deg^2) sum with the self-exclusion semantics."""
    return np.array([np.sum(1.0 / (z_t[i] - np.delete(z_all, idx[i])))
                     for i in range(len(idx))])


@pytest.mark.parametrize("deg,m", [(700, 700), (1500, 300), (300, 40)])
def test_repulsion_full_precision_matches_oracle(deg, m):
    """The chunked Aberth repulsion in full precision (lowprec=False)
    against the brute-force oracle: agreement to summation order only."""
    from fnft_tpu.ops.roots import _repulsion_chunked

    rng = np.random.default_rng(deg + m)
    z_all = rng.normal(size=deg) + 1j * rng.normal(size=deg)
    idx = np.sort(rng.choice(deg, size=m, replace=False)).astype(np.int32)
    got = np.asarray(_repulsion_chunked(jnp.asarray(z_all),
                                        jnp.asarray(z_all[idx]),
                                        jnp.asarray(idx), lowprec=False))
    ref = _repulsion_oracle(z_all, z_all[idx], idx)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-12


def test_repulsion_complex64_close_to_oracle():
    """The default low-precision path (complex64 reciprocals and sums)
    agrees with the oracle to f32 accumulation noise."""
    from fnft_tpu.ops.roots import _repulsion_chunked

    rng = np.random.default_rng(5)
    deg = 900
    z_all = rng.normal(size=deg) + 1j * rng.normal(size=deg)
    idx = np.arange(deg, dtype=np.int32)
    got = np.asarray(_repulsion_chunked(jnp.asarray(z_all),
                                        jnp.asarray(z_all),
                                        jnp.asarray(idx)))
    ref = _repulsion_oracle(z_all, z_all, idx)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-5


def test_repulsion_odd_sizes_match_oracle():
    """Sizes that are not multiples of the chunk, active subset unsorted."""
    from fnft_tpu.ops.roots import _repulsion_chunked

    rng = np.random.default_rng(9)
    deg, m = 97, 23
    z_all = rng.normal(size=deg) + 1j * rng.normal(size=deg)
    idx = rng.choice(deg, size=m, replace=False).astype(np.int32)
    got = np.asarray(_repulsion_chunked(jnp.asarray(z_all),
                                        jnp.asarray(z_all[idx]),
                                        jnp.asarray(idx), lowprec=False))
    ref = _repulsion_oracle(z_all, z_all[idx], idx)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-12


def test_sweep_block_localizes_roots():
    """A staged chunked-repulsion sweep block localizes the roots of a
    well-separated polynomial (the path aberth_roots takes above 4096)."""
    import fnft_tpu.ops.roots as roots

    rng = np.random.default_rng(13)
    true = rng.normal(size=24) + 1j * rng.normal(size=24)
    coeffs = np.poly(true)[::-1].copy()  # ascending
    z0 = jnp.asarray(roots._newton_polygon_init(np.abs(coeffs)))
    z, frozen, moved, n = roots._sweep_block(
        jnp.asarray(coeffs), z0, jnp.zeros(24, bool), 60)
    got = np.sort_complex(np.asarray(z))
    want = np.sort_complex(true)
    assert np.max(np.abs(got - want)) < 1e-8
