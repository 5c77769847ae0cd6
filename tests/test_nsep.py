"""Integration tests: nsep against analytic periodic spectra.

Ports the reference's plane-wave / constant testcases and bounds
(test/fnft_nsep/*, src/private/fnft__nsep_testcases.c).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import fnft_tpu as ft
from fnft_tpu.utils.misc import hausdorff_dist

BOX = (-10.0, 10.0, -10.0, 10.0)


def _filter(v, box):
    m = ((np.real(v) >= box[0]) & (np.real(v) <= box[1])
         & (np.imag(v) >= box[2]) & (np.imag(v) <= box[3]))
    return v[m]


def _remove(v, rb):
    m = ((np.real(v) > rb[0]) & (np.real(v) < rb[1])
         & (np.imag(v) > rb[2]) & (np.imag(v) < rb[3]))
    return v[~m]


def _plane_wave_case(d):
    """q = 2 exp(3it) on [0, 2pi): main spec -1.5 +- i sqrt(4 - j^2/4)
    (fnft__nsep_testcases.c:118-151)."""
    t_span = (0.0, 2 * np.pi)
    t = t_span[0] + (t_span[1] - t_span[0]) / d * np.arange(d)
    q = 2.0 * np.exp(3j * t)
    j = np.arange(50)
    sq = np.sqrt(4 - j * j / 4.0 + 0j)
    ms = np.concatenate([-1.5 + 1j * sq, -1.5 - 1j * sq])
    ja = np.arange(1, 50)
    sqa = np.sqrt(4 - ja * ja / 4.0 + 0j)
    aux = np.concatenate([-1.5 + 1j * sqa, -1.5 - 1j * sqa])
    remove_box = (-1.6, -1.4, -0.1, 0.1)  # slow convergence near -1.5
    return q, t_span, +1, ms, aux, remove_box


def _constant_defocusing_case(d):
    """q = (1+2i)/5 on [0,1): closed-form main/aux spectra
    (fnft__nsep_testcases.c:155-224)."""
    t_span = (0.0, 1.0)
    q = np.full(d, (1.0 + 2.0j) / 5.0)
    pi2 = np.pi ** 2
    ms = [1 / np.sqrt(5.0), -1 / np.sqrt(5.0),
          np.sqrt(5 * pi2 + 1) / np.sqrt(5.0), -np.sqrt(5 * pi2 + 1) / np.sqrt(5.0)]
    aux = [np.sqrt(5 * pi2 + 1) / np.sqrt(5.0), -np.sqrt(5 * pi2 + 1) / np.sqrt(5.0)]
    j = 1
    while 3 + 4 * j < 100:
        i = 3 + 4 * j
        v1 = np.sqrt(20 * pi2 * j * j + 1) / np.sqrt(5.0)
        v2 = np.sqrt(20 * pi2 * j * j + 20 * pi2 * j + 5 * pi2 + 1) / np.sqrt(5.0)
        ms += [v1, -v1, v2, -v2]
        aux += [v1, -v1, v2, -v2]
        j += 1
        del i
    ms = np.asarray(ms, complex)
    aux = np.asarray(aux, complex)
    return q, t_span, -1, ms, aux, (0.0, 0.0, 0.0, 0.0)


def _run(case_fn, d, disc, main_bound, aux_bound, box_override=None):
    q, t_span, kappa, ms_exact, aux_exact, rbox = case_fn(d)
    box = box_override or BOX
    opts = ft.NsepOpts(filtering=ft.PointFilter.MANUAL, bounding_box=box,
                       localization=ft.Localization.MIXED,
                       discretization=disc)
    res = ft.nsep(jnp.asarray(q), t_span, kappa=kappa, opts=opts)
    ms_e = _remove(_filter(ms_exact, box), rbox)
    aux_e = _remove(_filter(aux_exact, box), rbox)
    ms_g = _remove(_filter(np.asarray(res.main_spectrum), box), rbox)
    aux_g = _remove(_filter(np.asarray(res.aux_spectrum), box), rbox)
    assert ms_g.size > 0 and aux_g.size > 0
    em = float(hausdorff_dist(ms_g, ms_e))
    ea = float(hausdorff_dist(aux_g, aux_e))
    assert em <= main_bound, ("main", em, main_bound)
    assert ea <= aux_bound, ("aux", ea, aux_bound)
    return em, ea


# bounds from test/fnft_nsep/fnft_nsep_test_{plane_wave_focusing,constant_defocusing}_*.c
@pytest.mark.parametrize("disc,d,mb,ab", [
    (ft.Discretization.SPLIT2A, 1024, 3.2e-4, 2.9e-4),
    (ft.Discretization.SPLIT2_MODAL, 1024, 3.5e-4, 3.1e-4),
    (ft.Discretization.SPLIT4B, 1024, 9.6e-5, 4.4e-5),
    (ft.Discretization.SPLIT4A, 1024, 6.3e-5, 4.6e-5),
], ids=lambda v: str(getattr(v, "value", v)))
def test_nsep_plane_wave_focusing(disc, d, mb, ab):
    _run(_plane_wave_case, d, disc, mb, ab)


def test_nsep_plane_wave_nonreal_only():
    """With the box excluding the real line, errors drop an order
    (reference plane_wave 2split2A test, second part)."""
    _run(_plane_wave_case, 1024, ft.Discretization.SPLIT2A, 4.5e-5, 4.4e-5,
         box_override=(-10.0, 10.0, 0.1, 10.0))


@pytest.mark.parametrize("disc,d,mb,ab", [
    (ft.Discretization.SPLIT2A, 2048, 7.6e-5, 7.6e-8),
    (ft.Discretization.SPLIT2_MODAL, 2048, 7.6e-5, 7.6e-8),
    (ft.Discretization.SPLIT4B, 1024, 7.6e-5, 2.5e-8),
    (ft.Discretization.SPLIT4A, 512, 7.6e-5, 2.5e-8),
    (ft.Discretization.SPLIT4A4, 64, 6.8e-4, 1.3e-6),
], ids=lambda v: str(getattr(v, "value", v)))
def test_nsep_constant_defocusing(disc, d, mb, ab):
    _run(_constant_defocusing_case, d, disc, mb, ab)


def test_nsep_plane_wave_4split4B():
    _run(_plane_wave_case, 512, ft.Discretization.SPLIT4B4, 1.6e-4, 6.1e-7)


def test_nsep_spines():
    """points_per_spine > 2 samples the spines between the band edges."""
    d = 512
    t_span = (0.0, 2 * np.pi)
    t = t_span[0] + (t_span[1] - t_span[0]) / d * np.arange(d)
    q = 2.0 * np.exp(3j * t)
    opts2 = ft.NsepOpts(filtering=ft.PointFilter.MANUAL, bounding_box=BOX,
                        localization=ft.Localization.SUBSAMPLE_AND_REFINE,
                        points_per_spine=2)
    opts5 = ft.NsepOpts(filtering=ft.PointFilter.MANUAL, bounding_box=BOX,
                        localization=ft.Localization.SUBSAMPLE_AND_REFINE,
                        points_per_spine=5)
    r2 = ft.nsep(jnp.asarray(q), t_span, kappa=+1, want_aux=False, opts=opts2)
    r5 = ft.nsep(jnp.asarray(q), t_span, kappa=+1, want_aux=False, opts=opts5)
    assert len(r5.main_spectrum) > 1.5 * len(r2.main_spectrum)
    # spine points of the plane wave lie on Re = -1.5 or the real axis
    # (excluding the slowly-converging degenerate points near -1.5+0i,
    # which the reference testcase also removes with a remove_box)
    sp = np.asarray(r5.main_spectrum)
    off_axis = sp[np.abs(np.imag(sp)) > 0.05]
    assert np.max(np.abs(np.real(off_axis) + 1.5)) < 1e-3


def test_nsep_quasiperiodic_phase_shift():
    """A quasi-periodic plane wave handled via phase_shift must reproduce
    the shifted spectrum (CHANGELOG.md quasi-periodic support)."""
    d = 1024
    t_span = (0.0, 2 * np.pi)
    t = t_span[0] + (t_span[1] - t_span[0]) / d * np.arange(d)
    # q periodic: 2 exp(3it); multiply by exp(i*0.5*t) -> quasi-periodic
    q = 2.0 * np.exp(3.5j * t)
    phase_shift = 0.5 * (t_span[1] - t_span[0])
    opts = ft.NsepOpts(filtering=ft.PointFilter.MANUAL, bounding_box=BOX,
                       localization=ft.Localization.MIXED)
    res = ft.nsep(jnp.asarray(q), t_span, kappa=+1, phase_shift=phase_shift,
                  opts=opts)
    # spectrum of 2 exp(3it) shifted by -0.25 (lam_shift = -phase/(2L))
    j = np.arange(50)
    sq = np.sqrt(4 - j * j / 4.0 + 0j)
    ms_exact = np.concatenate([-1.5 + 1j * sq, -1.5 - 1j * sq]) - 0.25
    rbox = (-1.85, -1.65, -0.1, 0.1)
    ms_e = _remove(_filter(ms_exact, BOX), rbox)
    ms_g = _remove(_filter(np.asarray(res.main_spectrum), BOX), rbox)
    em = float(hausdorff_dist(ms_g, ms_e))
    assert em <= 5e-4, em


def test_nsep_defocusing_main_only_no_crash():
    """Regression: MIXED localization with kappa=-1 and want_aux=False
    left the batched root solve with zero polynomials and crashed on
    jnp.concatenate([]); it must return the gridsearch main spectrum."""
    q = np.full(64, 1.0, complex)
    r = ft.nsep(jnp.asarray(q), (0.0, 2 * np.pi), kappa=-1, want_aux=False)
    assert r.aux_spectrum is None
    assert r.main_spectrum is not None


def test_nsep_complex64_aux_not_dropped():
    """complex64 pipeline: the aux backward-error
    certificate must use the pipeline dtype's eps — with complex128 eps
    every c64 aux root was silently dropped (round-3 review finding)."""
    d = 256
    t_span = (0.0, 2 * np.pi)
    t = (t_span[1] - t_span[0]) / d * np.arange(d)
    q = (2.0 * np.exp(3j * t)).astype(np.complex64)
    opts = ft.NsepOpts(localization=ft.Localization.SUBSAMPLE_AND_REFINE,
                       filtering=ft.PointFilter.MANUAL,
                       bounding_box=(-5.0, 5.0, -5.0, 5.0))
    res = ft.nsep(jnp.asarray(q), t_span, kappa=+1, opts=opts)
    assert res.aux_spectrum.size > 0
    assert res.aux_spectrum.dtype == np.complex64
    j = np.arange(1, 50)
    sq = np.sqrt(4 - j * j / 4.0 + 0j)
    aux_e = np.concatenate([-1.5 + 1j * sq, -1.5 - 1j * sq])
    aux_e = aux_e[(np.abs(aux_e.real) < 5) & (np.abs(aux_e.imag) < 5)]
    err = max(float(np.min(np.abs(res.aux_spectrum - e)))
              for e in aux_e if abs(e.imag) > 0.3)
    assert err < 5e-3, err
