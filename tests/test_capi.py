"""C API (libfnft_tpu.so): build, ctypes equivalence, true embedding.

The in-process tier loads the library with ctypes — Py_IsInitialized()
is true, so the embedding layer reuses this interpreter and the calls
must agree with the Python drivers bit-for-bit. The embedded tier
compiles examples/capi_example.c into a standalone binary whose only
Python is the interpreter the library boots itself.
"""

import ctypes
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lib():
    from fnft_tpu import capi

    if not capi.have_capi():
        if shutil.which("gcc") is None:
            pytest.skip("no C toolchain")
        try:
            subprocess.run([sys.executable, "-m", "fnft_tpu.capi.build"],
                           check=True, capture_output=True, timeout=180)
        except Exception as e:  # pragma: no cover - toolchain-specific
            pytest.skip(f"cannot build C API: {e}")
    lib = ctypes.CDLL(str(capi.lib_path()))
    lib.fnft_tpu_last_error.restype = ctypes.c_char_p
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_version(lib):
    maj, mnr, pat = (ctypes.c_uint32() for _ in range(3))
    suf = ctypes.create_string_buffer(32)
    rc = lib.fnft_tpu_version(ctypes.byref(maj), ctypes.byref(mnr),
                              ctypes.byref(pat), suf)
    assert rc == 0
    import fnft_tpu

    assert (maj.value, mnr.value, pat.value) == \
        fnft_tpu.FNFT_REFERENCE_VERSION[:3]
    assert suf.value.decode().startswith("-tpu")


def _nsev_c(lib, q, t_span, m, xi_span, kappa, opts_json=None, kcap=8,
            ncs=1, csmult=1):
    d = q.shape[0]
    t = (ctypes.c_double * 2)(*t_span)
    xi = (ctypes.c_double * 2)(*xi_span)
    contspec = np.zeros(csmult * m, np.complex128)
    k = ctypes.c_size_t(kcap)
    bs = np.zeros(max(kcap, 1), np.complex128)
    nc = np.zeros(max(ncs * kcap, 1), np.complex128)
    rc = lib.fnft_tpu_nsev(
        ctypes.c_size_t(d), _ptr(q), t, ctypes.c_size_t(m), _ptr(contspec),
        xi, ctypes.byref(k), _ptr(bs), _ptr(nc), ctypes.c_int32(kappa),
        opts_json.encode() if opts_json else None)
    return rc, contspec, k.value, bs, nc


def test_nsev_matches_python_driver(lib):
    import fnft_tpu as ft

    ft.use_x64()
    d, m = 256, 8
    q = np.full(d, 2.0, np.complex128)
    rc, cs, k, bs, nc = _nsev_c(lib, q, (-1.0, 1.0), m, (-2.0, 2.0), +1)
    assert rc == 0, lib.fnft_tpu_last_error()
    ref = ft.nsev(q, (-1.0, 1.0), m=m, xi_span=(-2.0, 2.0), kappa=+1)
    np.testing.assert_allclose(cs, np.asarray(ref.reflection_coefficient),
                               rtol=0, atol=1e-14)
    assert k == np.asarray(ref.bound_states).size
    np.testing.assert_allclose(bs[:k], np.asarray(ref.bound_states),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(nc[:k], np.asarray(ref.norming_constants),
                               rtol=0, atol=1e-14)


def test_nsev_opts_json_ab_layout(lib):
    """contspec_type=ab: 2M entries, a then b (reference layout)."""
    import fnft_tpu as ft
    from fnft_tpu.models.nsev import ContspecType, NsevOpts

    ft.use_x64()
    d, m = 256, 8
    t = np.linspace(-8.0, 8.0, d)
    q = (1.3j / np.cosh(t)).astype(np.complex128)
    rc, cs, _, _, _ = _nsev_c(
        lib, q, (-8.0, 8.0), m, (-1.0, 1.0), +1,
        opts_json='{"contspec_type": "ab", "discretization": "2split4a"}',
        kcap=0, csmult=2)
    assert rc == 0, lib.fnft_tpu_last_error()
    ref = ft.nsev(q, (-8.0, 8.0), m=m, xi_span=(-1.0, 1.0), kappa=+1,
                  opts=NsevOpts(contspec_type=ContspecType.AB,
                                discretization=ft.Discretization.SPLIT4A))
    np.testing.assert_allclose(cs[:m], np.asarray(ref.a), rtol=0, atol=1e-14)
    np.testing.assert_allclose(cs[m:], np.asarray(ref.b), rtol=0, atol=1e-14)


def test_nsev_invalid_args(lib):
    q = np.full(4, 1.0, np.complex128)
    # reversed t_span must surface as rc=1 (invalid argument)
    rc, *_ = _nsev_c(lib, q, (1.0, -1.0), 4, (-2.0, 2.0), +1, kcap=0)
    assert rc == 1
    assert b"T" in lib.fnft_tpu_last_error() or \
        lib.fnft_tpu_last_error() != b""
    # NULL q pointer
    t = (ctypes.c_double * 2)(-1.0, 1.0)
    rc = lib.fnft_tpu_nsev(ctypes.c_size_t(4), None, t, ctypes.c_size_t(0),
                           None, None, None, None, None,
                           ctypes.c_int32(1), None)
    assert rc == 1


def test_kdvv(lib):
    import fnft_tpu as ft

    ft.use_x64()
    d, m = 256, 16
    t = np.linspace(-10.0, 10.0, d)
    u = (2.0 / np.cosh(t) ** 2).astype(np.complex128)
    tt = (ctypes.c_double * 2)(-10.0, 10.0)
    xi = (ctypes.c_double * 2)(0.1, 2.0)
    cs = np.zeros(m, np.complex128)
    rc = lib.fnft_tpu_kdvv(ctypes.c_size_t(d), _ptr(u), tt,
                           ctypes.c_size_t(m), _ptr(cs), xi, None, None,
                           None)
    assert rc == 0, lib.fnft_tpu_last_error()
    ref = ft.kdvv(u, (-10.0, 10.0), m=m, xi_span=(0.1, 2.0))
    np.testing.assert_allclose(cs, np.asarray(ref.reflection_coefficient),
                               rtol=0, atol=1e-14)


def test_nsep(lib):
    import fnft_tpu as ft

    ft.use_x64()
    d = 256
    t = (2 * np.pi / d) * np.arange(d)
    q = (2.0 * np.exp(3j * t)).astype(np.complex128)
    tt = (ctypes.c_double * 2)(0.0, 2 * np.pi)
    k = ctypes.c_size_t(64)
    m = ctypes.c_size_t(64)
    main = np.zeros(64, np.complex128)
    aux = np.zeros(64, np.complex128)
    opts = (b'{"localization": "subsample_and_refine", '
            b'"filtering": "manual", "bounding_box": [-5, 5, -5, 5]}')
    rc = lib.fnft_tpu_nsep(ctypes.c_size_t(d), _ptr(q), tt,
                           ctypes.c_double(0.0), ctypes.byref(k),
                           _ptr(main), ctypes.byref(m), _ptr(aux), None,
                           ctypes.c_int32(1), opts)
    assert rc == 0, lib.fnft_tpu_last_error()
    from fnft_tpu.models.nsep import Localization, NsepOpts, PointFilter

    ref = ft.nsep(q, (0.0, 2 * np.pi), kappa=+1, opts=NsepOpts(
        localization=Localization.SUBSAMPLE_AND_REFINE,
        filtering=PointFilter.MANUAL, bounding_box=(-5, 5, -5, 5)))
    assert k.value == np.asarray(ref.main_spectrum).size
    assert m.value == np.asarray(ref.aux_spectrum).size
    np.testing.assert_allclose(main[:k.value],
                               np.asarray(ref.main_spectrum), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(aux[:m.value], np.asarray(ref.aux_spectrum),
                               rtol=0, atol=1e-14)
    # sheet_indices: same "not implemented, pass NULL" contract as the
    # reference (fnft_nsep.h:251)
    sheet = (ctypes.c_double * 4)()
    rc = lib.fnft_tpu_nsep(ctypes.c_size_t(d), _ptr(q), tt,
                           ctypes.c_double(0.0), ctypes.byref(k),
                           _ptr(main), ctypes.byref(m), _ptr(aux), sheet,
                           ctypes.c_int32(1), None)
    assert rc == 1


def test_nsev_inverse_multisoliton(lib):
    import fnft_tpu as ft

    ft.use_x64()
    d = 512
    bs = np.array([1.0j], np.complex128)
    nc = np.array([-1.0j], np.complex128)
    q = np.zeros(d, np.complex128)
    tt = (ctypes.c_double * 2)(-16.0, 16.0)
    xi = (ctypes.c_double * 2)(-1.0, 1.0)
    rc = lib.fnft_tpu_nsev_inverse(
        ctypes.c_size_t(0), None, xi, ctypes.c_size_t(1), _ptr(bs),
        _ptr(nc), ctypes.c_size_t(d), _ptr(q), tt, ctypes.c_int32(1), None)
    assert rc == 0, lib.fnft_tpu_last_error()
    ref = ft.nsev_inverse(None, (-1.0, 1.0), d, (-16.0, 16.0), kappa=+1,
                          bound_states=bs, normconsts_or_residues=nc)
    np.testing.assert_allclose(q, np.asarray(ref), rtol=0, atol=1e-14)
    # the 1-soliton closed form: sech-shaped with peak 2*eta = 2 (sampled
    # on a 0.063-step grid, so the observed max sits slightly below it)
    assert abs(np.max(np.abs(q)) - 2.0) < 5e-3


def test_embedded_binary(lib, tmp_path):
    """True embedding: a standalone C program boots its own interpreter."""
    if shutil.which("gcc") is None:
        pytest.skip("no C toolchain")
    from fnft_tpu import capi

    exe = tmp_path / "capi_example"
    subprocess.run(
        ["gcc", str(REPO / "examples" / "capi_example.c"),
         f"-I{capi.lib_path().parent}", f"-L{capi.lib_path().parent}",
         "-lfnft_tpu", f"-Wl,-rpath,{capi.lib_path().parent}",
         "-o", str(exe)], check=True, capture_output=True)
    import os

    env = dict(os.environ, FNFT_TPU_PLATFORM="cpu")
    r = subprocess.run([str(exe)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-500:]
    assert "discrete spectrum (K = 1)" in r.stdout
    assert "+1.574226I" in r.stdout
