"""Double-float (float32-pair) arithmetic: the float32-only high-precision path."""

import jax
import numpy as np
import jax.numpy as jnp

import fnft_tpu.ops.poly as poly
from fnft_tpu.ops.df64 import (
    cdf_from_c128,
    cdf_to_c128,
    df_add,
    df_from_f64,
    df_mul,
    df_to_f64,
    fft_df64,
    fmult2x2_tree_df64,
)


def test_df_mul_vmap_broadcast_operand():
    """Regression: jit(vmap(df_mul, in_axes=(0, None))) degraded to plain
    f32 accuracy when one operand was an unbatched broadcast — XLA:CPU
    mangles the error-free transformations across broadcast_in_dim. The
    _df_align pre-broadcast keeps the pair exact (~1e-14)."""
    import jax

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 1000))
    y = rng.normal(size=1000)
    xs = jax.tree.map(jnp.asarray, df_from_f64(x))
    ys = jax.tree.map(jnp.asarray, df_from_f64(y))
    out = jax.jit(jax.vmap(df_mul, in_axes=(0, None)))(xs, ys)
    got = np.asarray(df_to_f64(jax.tree.map(lambda t: t[0], out)))
    assert np.max(np.abs(got - x[0] * y)) < 1e-13


def test_df_primitives():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=512))
    y = jnp.asarray(rng.normal(size=512))
    add = df_to_f64(df_add(df_from_f64(x), df_from_f64(y)))
    mul = df_to_f64(df_mul(df_from_f64(x), df_from_f64(y)))
    assert float(jnp.max(jnp.abs(add - (x + y)))) < 5e-14
    assert float(jnp.max(jnp.abs(mul - (x * y)))) < 5e-14


def test_df64_fft_double_precision_class():
    rng = np.random.default_rng(1)
    z = rng.normal(size=(3, 256)) + 1j * rng.normal(size=(3, 256))
    got = np.asarray(cdf_to_c128(fft_df64(cdf_from_c128(jnp.asarray(z)), 256)))
    ref = np.fft.fft(z, axis=-1)
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-13
    back = np.asarray(cdf_to_c128(fft_df64(cdf_from_c128(jnp.asarray(ref)),
                                           256, inverse=True)))
    assert np.max(np.abs(back - z)) / np.max(np.abs(z)) < 1e-13


def test_df64_transfer_matrix_coeffs():
    """df64 one-step matrices match complex128 to ~1e-14 (series expm).

    Validated to 8e-15 (SPLIT4B), 8e-16 (SPLIT2A), 1.2e-14 (SPLIT4A)."""
    import fnft_tpu as ft
    from fnft_tpu.ops.df64 import cdf_from_c128
    from fnft_tpu.ops.df64_pipeline import transfer_matrix_coeffs_df64
    from fnft_tpu.ops.fscatter import transfer_matrix_coeffs

    rng = np.random.default_rng(0)
    q = 0.7 * (rng.normal(size=16) + 1j * rng.normal(size=16))
    r = -np.conj(q)
    disc = ft.Discretization.SPLIT4B
    got = np.asarray(cdf_to_c128(transfer_matrix_coeffs_df64(
        cdf_from_c128(jnp.asarray(q)), cdf_from_c128(jnp.asarray(r)),
        0.12, disc)))
    ref = np.asarray(transfer_matrix_coeffs(jnp.asarray(q),
                                            jnp.asarray(r), 0.12, disc))
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-13


def test_df64_full_contspec_pipeline():
    """End-to-end df64 contspec matches the complex128 driver to ~1e-13
    at D=1024 with the full M=D chirp grid, including the batched path.

    (complex64 at the same size errs at ~7e-6; measured df64 deviation is
    ~1e-13. First call costs ~30 s of one-time XLA compile on 1 CPU core;
    the staged programs are cached afterwards.)"""
    import fnft_tpu as ft
    from fnft_tpu.ops.df64_pipeline import nsev_contspec_df64
    from fnft_tpu.testcases import NsevTestcase, nsev_testcase

    d = 1024
    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    rho = np.asarray(nsev_contspec_df64(jnp.asarray(data.q), d=d,
                                        m=d, t_span=data.t_span,
                                        xi_span=data.xi_span))
    ref = np.asarray(ft.nsev(jnp.asarray(data.q), data.t_span, m=d,
                             xi_span=data.xi_span, kappa=+1,
                             want_bound_states=False).reflection_coefficient)
    # both pipelines sit at complex128 roundoff; the bound leaves room
    # for the value-space tree's slightly different roundoff pattern
    assert np.sum(np.abs(rho - ref)) / np.sum(np.abs(ref)) < 5e-12

    # batched rows reproduce the single-signal results
    qb = np.stack([np.asarray(data.q), 0.5 * np.asarray(data.q)])
    rb = np.asarray(nsev_contspec_df64(qb, d=d, m=d, t_span=data.t_span,
                                       xi_span=data.xi_span))
    assert rb.shape == (2, d)
    np.testing.assert_allclose(rb[0], rho, rtol=1e-10, atol=1e-12)


def test_df64_bound_states_polish():
    """df64 bound states: Newton polish against the df64 transfer
    polynomial reaches ~5e-9 of the polynomial's true roots (sequential
    Horner rounding floor at deg 2048) — vs ~1e-5 for complex64, and far
    below the discretization's own ~1e-5 method error at D=1024."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from fnft_tpu.ops.df64_pipeline import nsev_boundstates_df64
    from fnft_tpu.testcases import NsevTestcase, nsev_testcase

    d = 1024
    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    lam = nsev_boundstates_df64(data.q, d=d, t_span=data.t_span)
    lam = lam[np.argsort(lam.imag)]
    assert lam.size == 3
    # float64 Newton on the same polynomial gives these roots (the SPLIT4B
    # discretization's own bound states at D=1024)
    truth = np.array([0.69998415j, 1.6999083j, 2.69977704j])
    assert np.max(np.abs(lam - truth)) < 1e-7, lam
    # and they sit within the discretization error of the analytic states
    np.testing.assert_allclose(lam, data.bound_states, atol=5e-4)


def test_df64_tree_beats_complex64_by_orders():
    rng = np.random.default_rng(2)
    n, c = 128, 3
    p = 0.5 * (rng.normal(size=(n, 2, 2, c)) + 1j * rng.normal(size=(n, 2, 2, c)))
    r_df, w_df = fmult2x2_tree_df64(jnp.asarray(p))
    r64, w64 = poly.fmult2x2_tree(jnp.asarray(p))
    r32, w32 = poly.fmult2x2_tree(jnp.asarray(p.astype(np.complex64)))
    # the value-space tree rescales off value (not coefficient) magnitudes,
    # so the exponents may differ; only stored * 2^w is the contract
    scale = np.max(np.abs(np.asarray(r64)))
    dev_df = np.max(np.abs(np.asarray(r_df)
                           * 2.0 ** float(int(w_df) - int(w64))
                           - np.asarray(r64))) / scale
    dev_32 = np.max(np.abs(np.asarray(r32).astype(complex)
                           * 2.0 ** float(int(w32) - int(w64))
                           - np.asarray(r64))) / scale
    assert dev_df < 1e-11, dev_df
    assert dev_df < 1e-4 * max(dev_32, 1e-30)  # orders-of-magnitude win


def test_df64_value_tree_matches_classic_and_brute_force():
    """The df64 value-space levels (ops/df64._value_level_df64) must agree
    with the classic padded coefficient product at df64 precision, and the
    ``want`` selection must zero exactly the unrequested entries."""
    import fnft_tpu.ops.df64_pipeline as pl

    rng = np.random.default_rng(41)
    n, deg = 128, 1   # c-1 reaches 16 with 3 levels left -> value path
    p = rng.normal(size=(n, 2, 2, deg + 1)) \
        + 1j * rng.normal(size=(n, 2, 2, deg + 1))

    def matmul(b, a):
        out = np.zeros((2, 2, b.shape[-1] + a.shape[-1] - 1), complex)
        for i in range(2):
            for j in range(2):
                for k in range(2):
                    out[i, j] += np.convolve(b[i, k], a[k, j])
        return out

    acc = p[0]
    for m_ in p[1:]:
        acc = matmul(m_, acc)
    scale = np.max(np.abs(acc))

    assert pl._VALUE_TREE_DF64  # the production default
    got_v, w_v = fmult2x2_tree_df64(p)
    val_v = np.asarray(got_v) * 2.0 ** int(w_v)
    assert np.max(np.abs(val_v - acc)) / scale < 1e-12

    try:
        pl._VALUE_TREE_DF64 = False
        jax.clear_caches()
        got_c, w_c = fmult2x2_tree_df64(p)
    finally:
        pl._VALUE_TREE_DF64 = True
        jax.clear_caches()
    val_c = np.asarray(got_c) * 2.0 ** int(w_c)
    assert np.max(np.abs(val_c - acc)) / scale < 1e-12

    got_s, w_s = fmult2x2_tree_df64(p, want=((0, 0), (1, 0)))
    val_s = np.asarray(got_s) * 2.0 ** int(w_s)
    assert np.max(np.abs(val_s[0, 0] - acc[0, 0])) / scale < 1e-12
    assert np.max(np.abs(val_s[1, 0] - acc[1, 0])) / scale < 1e-12
    assert np.all(val_s[0, 1] == 0) and np.all(val_s[1, 1] == 0)


def test_df64_contspec_at_scale_d_2pow16():
    """df64 contspec at D=2^16 with the full M=D grid vs the complex128
    driver — the at-scale evidence for 'reference tolerance in float32 pairs'
    (gated: minutes on 1 CPU core; the roofline doc extrapolates 2^20).

    Bound model: the dominant error is the per-sample accumulation of
    df64's 48-bit roundoff through the D-deep matrix product, linear in
    D; measured err ~ 0.23 * D * 2^-48 across D = 2^10..2^16 (the FFT
    contribution is flat ~7e-15 at every size, ruled out separately).
    The bound is 0.5 * D * 2^-48 — 2x the fitted constant — i.e. 1.2e-10
    at D=2^16, still ~5e3x below the discretization error there.  (An
    earlier fixed 1e-11 bound passed only while the df64 and c128 trees
    were structurally identical and their roundings correlated; the
    value-space tree decorrelated them.)"""
    import os

    import pytest

    if not os.environ.get("FNFT_SLOW_TESTS"):
        pytest.skip("set FNFT_SLOW_TESTS=1 to run (minutes on 1 CPU core)")
    import fnft_tpu as ft
    from fnft_tpu.ops.df64_pipeline import nsev_contspec_df64
    from fnft_tpu.testcases import NsevTestcase, nsev_testcase

    d = 1 << 16
    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    rho = np.asarray(nsev_contspec_df64(jnp.asarray(data.q), d=d, m=d,
                                        t_span=data.t_span,
                                        xi_span=data.xi_span))
    ref = np.asarray(ft.nsev(jnp.asarray(data.q), data.t_span, m=d,
                             xi_span=data.xi_span, kappa=+1,
                             want_bound_states=False).reflection_coefficient)
    err = np.sum(np.abs(rho - ref)) / np.sum(np.abs(ref))
    assert err < 0.5 * d * 2.0 ** -48, err


def test_df64_fft_large_n_x64_off_subprocess():
    """Regression: the loop-FFT twiddle index grp*(n//2)//m overflowed
    int32 for n >= 2^17 when jax x64 is off (the float32 mode), silently
    corrupting every large df64 FFT. Verified in a subprocess with x64
    disabled (the suite itself runs with x64 on, which hid the bug)."""
    import subprocess
    import sys

    code = """
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np, jax.numpy as jnp
from fnft_tpu.ops.df64 import cdf_from_c128, cdf_to_c128, fft_df64
n = 1 << 17
rng = np.random.default_rng(0)
z = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex128)
out = np.asarray(cdf_to_c128(fft_df64(cdf_from_c128(z), n)))
ref = np.fft.fft(z)
err = np.max(np.abs(out - ref)) / np.max(np.abs(ref))
assert err < 1e-12, err
print('OK', err)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd="/root/repo")
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr


def test_df64_contspec_x64_off_subprocess():
    """Regression: nsev_contspec_df64 used jnp.asarray on its complex128
    input, which truncates to complex64 when jax x64 is off (the float32
    mode) and zeroes every lo plane — capping accuracy at ~1e-7. With the
    host-side split the x64-off pipeline must match the x64 complex128
    driver to ~1e-12."""
    import subprocess
    import sys

    import fnft_tpu as ft
    from fnft_tpu.testcases import NsevTestcase, nsev_testcase

    d = 256
    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    ref = np.asarray(ft.nsev(jnp.asarray(data.q), data.t_span, m=d,
                             xi_span=data.xi_span, kappa=+1,
                             want_bound_states=False).reflection_coefficient)
    np.save("/tmp/df64_x64off_ref.npy", ref)

    code = f"""
import jax; jax.config.update('jax_platforms', 'cpu')
import numpy as np
from fnft_tpu.ops.df64_pipeline import nsev_contspec_df64
from fnft_tpu.testcases import NsevTestcase, nsev_testcase
assert not jax.config.jax_enable_x64
data = nsev_testcase(NsevTestcase.SECH_FOCUSING, {d})
rho = nsev_contspec_df64(data.q, d={d}, m={d}, t_span=data.t_span,
                         xi_span=data.xi_span)
ref = np.load('/tmp/df64_x64off_ref.npy')
err = np.sum(np.abs(rho - ref)) / np.sum(np.abs(ref))
assert err < 1e-11, err
print('OK', err)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=900, cwd="/root/repo")
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr


def test_df64_kdvv_contspec():
    """KdV reflection coefficient in df64 matches the complex128 driver
    to ~5e-14 (complex64: ~3e-6) — the precision layer covers both
    equation families."""
    import fnft_tpu as ft
    from fnft_tpu.ops.df64_pipeline import kdvv_contspec_df64

    d, m = 1024, 16
    t_span, xi_span = (-10.0, 10.0), (0.1, 3.0)
    t = np.linspace(*t_span, d)
    u = (3.2 / np.cosh(t) ** 2).astype(complex)
    opts = ft.KdvvOpts(discretization=ft.Discretization.SPLIT4B)
    ref = np.asarray(ft.kdvv(jnp.asarray(u), t_span, m=m, xi_span=xi_span,
                             opts=opts).reflection_coefficient)
    rho = kdvv_contspec_df64(u, d=d, m=m, t_span=t_span, xi_span=xi_span)
    assert np.sum(np.abs(rho - ref)) / np.sum(np.abs(ref)) < 5e-12


def test_df64_libm():
    """exp/log/log1p/sincos in df64 reach ~1e-13 (needed by specfact).
    df_exp scales with ldexp: jnp.exp2 itself is INEXACT on XLA:CPU
    (~1e-6 rel in f32 even for integer args — the reason every 2^w
    rescale in the framework uses ldexp)."""
    from fnft_tpu.ops.df64 import (df_exp, df_from_f64, df_log, df_log1p,
                                   df_sincos, df_to_f64)

    rng = np.random.default_rng(0)
    x = rng.uniform(-20, 20, 2048)
    sp = lambda v: tuple(map(jnp.asarray, df_from_f64(v)))  # noqa: E731
    ex = np.asarray(df_to_f64(df_exp(sp(x))))
    assert np.max(np.abs(ex - np.exp(x)) / np.exp(x)) < 1e-12
    xp = rng.uniform(1e-6, 1e6, 2048)
    lg = np.asarray(df_to_f64(df_log(sp(xp))))
    assert np.max(np.abs(lg - np.log(xp))) < 1e-12
    l1p = np.asarray(df_to_f64(df_log1p(sp(np.abs(x) / 20))))
    assert np.max(np.abs(l1p - np.log1p(np.abs(x) / 20))) < 1e-12
    s, c = df_sincos(sp(x))
    assert np.max(np.abs(np.asarray(df_to_f64(s)) - np.sin(x))) < 1e-12
    assert np.max(np.abs(np.asarray(df_to_f64(c)) - np.cos(x))) < 1e-12


def test_ldexp_exact_vs_exp2():
    """Documents the platform fact driving the ldexp choice: on this
    XLA:CPU, jnp.exp2 errs up to ~1e-6 (f32) / ~2.4e-15 (f64) even on
    integer args, while ldexp is bit-exact. The framework's 2^w rescales
    therefore use ldexp everywhere."""
    n = jnp.arange(-40, 41, dtype=jnp.int32)
    exact = np.exp2(np.arange(-40, 41, dtype=np.float64))
    l32 = np.asarray(jnp.ldexp(jnp.float32(1.0), n), np.float64)
    assert np.array_equal(l32, exact)
    # exp2's error is real but bounded (if a future XLA makes it exact,
    # this still holds — ldexp remains the safe choice either way)
    e32 = np.asarray(jnp.exp2(n.astype(jnp.float32)), np.float64)
    err32 = np.max(np.abs(e32 - exact) / exact)
    assert err32 <= 2e-6, err32


def test_df64_bound_states_batched():
    """Batched df64 polish matches the single-signal path row by row,
    with per-signal counts padded to k_max + mask."""
    from fnft_tpu.ops.df64_pipeline import (nsev_boundstates_df64,
                                            nsev_boundstates_df64_batched)

    t = np.linspace(-25, 25, 512)
    q1 = 1j * 3.2 / np.cosh(t)
    q2 = 1j * 1.2 / np.cosh(t)
    lam_b, mask = nsev_boundstates_df64_batched(
        np.stack([q1, q2]), d=512, t_span=(-25.0, 25.0))
    assert list(mask.sum(1)) == [3, 1]
    l1 = nsev_boundstates_df64(q1, d=512, t_span=(-25.0, 25.0))
    np.testing.assert_allclose(np.sort(lam_b[0][mask[0]].imag),
                               np.sort(l1.imag), atol=1e-9)
