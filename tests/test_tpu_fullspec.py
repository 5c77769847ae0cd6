"""Complex-free full-spectrum pipeline: rc Aberth + df64 sweeps.

Validates the complex-free lowerings of the discrete-spectrum path against the
complex (c128) implementations and the analytic Satsuma-Yajima spectrum,
on the CPU backend (the math is backend-agnostic; tests/conftest.py pins
CPU). Reference bounds: test/fnft_nsev/fnft_nsev_test_sech_focusing_*
scaled by 2nd-order convergence to the test resolution.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fnft_tpu.testcases import NsevTestcase, nsev_testcase, nsev_errors


def test_aberth_rc_matches_numpy_roots():
    from fnft_tpu.ops.tpu_roots import poly_roots_rc

    rng = np.random.default_rng(7)
    c = (rng.standard_normal(25) + 1j * rng.standard_normal(25)).astype(
        np.complex64)
    rr, ri = poly_roots_rc((jnp.asarray(c.real), jnp.asarray(c.imag)))
    got = np.asarray(rr) + 1j * np.asarray(ri)
    import numpy.polynomial.polynomial as P

    ref = P.polyroots(c.astype(np.complex128))
    d = np.abs(got[:, None] - ref[None, :]).min(axis=1)
    assert d.max() < 5e-3  # f32 tier: Newton seeds, not certified roots


def test_aberth_rc_unit_circle_cluster():
    from fnft_tpu.ops.tpu_roots import poly_roots_rc
    import numpy.polynomial.polynomial as P

    rng = np.random.default_rng(3)
    z = np.exp(1j * 2 * np.pi * rng.random(12)) * (1 - 1e-3 * rng.random(12))
    c = P.polyfromroots(z).astype(np.complex64)
    rr, ri = poly_roots_rc((jnp.asarray(c.real), jnp.asarray(c.imag)))
    got = np.asarray(rr) + 1j * np.asarray(ri)
    d = np.abs(got[:, None] - z[None, :]).min(axis=1)
    assert d.max() < 1e-3


def test_locate_boundstates_on_device():
    from fnft_tpu.ops.tpu_fullspec import locate_boundstates_tpu

    d = 1024
    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    q = np.asarray(data.q, np.complex128)
    cand = locate_boundstates_tpu(q, data.t_span)
    bt = np.asarray(data.bound_states)
    assert cand.size == bt.size
    dist = np.abs(cand[:, None] - bt[None, :]).min(axis=1)
    # subsample-stage accuracy: O(eps_sub^2) Newton seeds
    assert dist.max() < 5e-3


def test_df64_sweeps_match_complex_path():
    from fnft_tpu.ops.df64_boundstates import (ab_at_states_df64,
                                               newton_refine_df64)
    from fnft_tpu.ops.scatter import scatter_bound_states
    from fnft_tpu.models.discretization import Discretization

    d = 256
    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    q = np.asarray(data.q, np.complex128)
    bt = np.asarray(data.bound_states)
    lam = newton_refine_df64(q, bt + (0.002 - 0.003j), data.t_span, niter=6)
    eps_t = (data.t_span[1] - data.t_span[0]) / (d - 1)
    a_c, ap_c, b_c = scatter_bound_states(
        jnp.asarray(q), jnp.asarray(-np.conj(q)), jnp.asarray(lam), eps_t,
        data.t_span[0], data.t_span[1], Discretization.BO, skip_b=False)
    _a_d, ap_d, b_d = ab_at_states_df64(q, lam, data.t_span)
    assert np.max(np.abs(ap_d - np.asarray(ap_c)) / np.abs(ap_c)) < 1e-10
    assert np.max(np.abs(b_d - np.asarray(b_c)) / np.abs(b_c)) < 1e-12
    # Newton refinement lands within the (scaled) reference Hausdorff bound
    assert np.abs(np.sort(lam.imag) - np.sort(bt.imag)).max() \
        < 1.6e-5 * (4096 / d) ** 2


def test_fullspec_df64_reference_bounds_scaled():
    from fnft_tpu.ops.tpu_fullspec import nsev_fullspec_df64

    d = 256
    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    q = np.asarray(data.q, np.complex128)
    out = nsev_fullspec_df64(q, data.t_span, m=data.m,
                             xi_span=data.xi_span, niter=8)

    class R:
        pass

    r = R()
    r.reflection_coefficient = out["rho"]
    r.a = r.b = None
    r.bound_states = out["bound_states"]
    r.norming_constants = out["norming_constants"]
    r.residues = out["residues"]
    errs = nsev_errors(r, data)
    scale = (4096 / d) ** 2
    # 1.15 headroom: pure h^2 scaling underestimates the D=256 error by a
    # few % (higher-order terms; measured 1.04e-3 vs 2nd-order 9.98e-4 —
    # the un-scaled bound itself is met at D=4096, watcher stage
    # fullspec_D4096_harness)
    assert errs["contspec"] <= 3.9e-6 * scale * 1.15
    assert errs["bound_states"] <= 1.6e-5 * scale * 1.15
    assert errs["normconsts"] <= 5e-14 * 2  # df64 floor at tiny D
    assert errs["residues"] <= 2.1e-6 * scale * 1.15
