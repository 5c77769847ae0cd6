"""Smoke run of the public drivers on one GPU, in complex128.

Runs each phase once through the public API at the size users run it,
times it (cold: compile included; warm: best of 3, each ending in
``block_until_ready``), compares the result with an independent reference
and holds it to the reference library's own error bound. Prints one JSON
line per phase, the card's name and power limit, and as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

A phase outside its bound, or no GPU, ends the run with a non-zero exit
code and no result line. There is no CPU fallback and no interpret mode.

    python chip_smoke.py                 # default phases, one GPU
    python chip_smoke.py --phase kdvv_2p17 --phase nsep_2p14
    python chip_smoke.py --multi         # sharded paths on four GPUs
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np

REPS = 3


# ---------------------------------------------------------------------------
# bound rules
# ---------------------------------------------------------------------------

def scaled_bound(bound_4096: float, d: int, floor: float = 1e-8) -> float:
    """A reference bound stated at D=4096, carried to D by the schemes'
    second-order convergence, with a floor for double-precision roundoff."""
    return max(bound_4096 * (4096.0 / d) ** 2, floor)


# the reference's six bounds for SECH_FOCUSING with 2SPLIT4B at D=4096
# (test/fnft_nsev/fnft_nsev_test_sech_focusing_2split4B.c:31-43)
NSEV_BOUNDS_4096 = {"contspec": 3.9e-6, "a": 6.3e-6, "b": 2.0e-6,
                    "bound_states": 1.6e-5, "normconsts": 5e-14,
                    "residues": 2.1e-6}


def nsev_full_bounds(d: int) -> dict:
    """The six bounds at D; away from D=4096 the discretization-limited ones
    scale as D^-2 and the norming constants get a roundoff floor."""
    if d == 4096:
        return dict(NSEV_BOUNDS_4096)
    out = {k: scaled_bound(v, d, 5e-8 if k == "bound_states" else 1e-8)
           for k, v in NSEV_BOUNDS_4096.items()}
    out["normconsts"] = 1e-12
    return out


# ---------------------------------------------------------------------------
# phases: each builder returns (run, check); run() is the timed public call,
# check(out) -> {name: (error, bound)}
# ---------------------------------------------------------------------------

def _result_arrays(res) -> dict:
    return {k: v for k, v in vars(res).items() if v is not None}


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def phase_nsev_rho(d: int):
    """Reflection coefficient of 3.2i sech(t), D = M, XI = (-2, 2)."""
    import jax.numpy as jnp

    import fnft_tpu as ft
    from fnft_tpu.testcases import NsevTestcase, nsev_errors, nsev_testcase

    t = np.linspace(-25.0, 25.0, d)
    q = jnp.asarray(3.2j / np.cosh(t))

    def run():
        return ft.nsev(q, (-25.0, 25.0), m=d, xi_span=(-2.0, 2.0),
                       want_bound_states=False).reflection_coefficient

    def check(rho):
        # |rho| is even in xi: the grid point nearest 0 reads |rho(0)|
        rho0 = float(np.abs(np.asarray(rho)[d // 2]))
        data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
        res = ft.nsev(jnp.asarray(data.q), data.t_span, m=data.m,
                      xi_span=data.xi_span, want_bound_states=False)
        err = nsev_errors(res, data)["contspec"]
        bound = scaled_bound(3.9e-6, d)
        return {"abs_rho0": (abs(rho0 - 0.7265425), max(bound, 1e-6)),
                "contspec": (err, bound)}

    return run, check


def phase_nsev_full(d: int):
    """Full spectrum (a, b, rho, bound states, norming constants,
    residues) of SECH_FOCUSING against its analytic spectrum."""
    import jax.numpy as jnp

    import fnft_tpu as ft
    from fnft_tpu.testcases import NsevTestcase, nsev_errors, nsev_testcase

    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)
    q = jnp.asarray(data.q)
    opts = ft.NsevOpts(contspec_type=ft.ContspecType.BOTH,
                       discspec_type=ft.DiscspecType.BOTH)

    def run():
        return _result_arrays(ft.nsev(q, data.t_span, m=data.m,
                                      xi_span=data.xi_span, opts=opts))

    def check(out):
        res = ft.NsevResult(**out)
        errs = nsev_errors(res, data)
        return {k: (errs[k], b) for k, b in nsev_full_bounds(d).items()}

    return run, check


def phase_nsev_batch(d: int, batch: int, mesh=None):
    """make_nsev_batch_fn on ``batch`` sech pulses of distinct amplitude,
    rows checked against single ft.nsev calls."""
    import jax.numpy as jnp

    import fnft_tpu as ft
    from fnft_tpu.parallel.sharding import make_nsev_batch_fn

    t = np.linspace(-25.0, 25.0, d)
    amps = np.linspace(0.5, 4.0, batch)
    qb = jnp.asarray(1j * amps[:, None] / np.cosh(t)[None, :])
    fn = make_nsev_batch_fn(d, (-25.0, 25.0), d, (-2.0, 2.0), mesh=mesh)

    def run():
        return fn(qb)["rho"]

    def check(rho):
        rows = (0, batch // 2, batch - 1)
        diff = max(_rel(np.asarray(rho)[r], ft.nsev(
            qb[r], (-25.0, 25.0), m=d, xi_span=(-2.0, 2.0),
            want_bound_states=False).reflection_coefficient) for r in rows)
        return {"rows_vs_single": (diff, 1e-10)}

    return run, check


def kdvv_sech2_case(d: int, m: int):
    """u = 3.2 sech^2(t) on (-16, 15) and its closed-form reflection
    coefficient on the M-point grid over (-71/20, 79/20) (tests/test_kdvv.py,
    after fnft__kdvv_testcases.c)."""
    import scipy.special as sp

    a_amp, t_span = 3.2, (-16.0, 15.0)
    xi_span = (-71.0 / 20.0, 79.0 / 20.0)
    u = a_amp / np.cosh(np.linspace(*t_span, d)) ** 2
    xi = np.linspace(*xi_span, m)
    s = np.sqrt(a_amp + 0.25)
    at, bt, ct = 0.5 - 1j * xi + s, 0.5 - 1j * xi - s, 1.0 - 1j * xi
    a_of = sp.gamma(at) * sp.gamma(bt) / (sp.gamma(ct)
                                          * sp.gamma(at + bt - ct))
    rho = a_of * sp.gamma(ct) * sp.gamma(ct - at - bt) / (
        sp.gamma(ct - at) * sp.gamma(ct - bt))
    return u, t_span, xi_span, rho


def phase_kdvv(d: int):
    """kdvv contspec, D = M, real potential (real-coefficient tree)."""
    import jax.numpy as jnp

    import fnft_tpu as ft
    from fnft_tpu.utils.misc import rel_err

    u, t_span, xi_span, rho_exact = kdvv_sech2_case(d, d)
    uj = jnp.asarray(u)

    def run():
        return ft.kdvv(uj, t_span, m=d, xi_span=xi_span).reflection_coefficient

    def check(rho):
        err = float(rel_err(rho, jnp.asarray(rho_exact)))
        # the SPLIT4B rule of tests/test_kdvv.py, scaled to D
        return {"contspec": (err, scaled_bound(3.05e-5, d))}

    return run, check


def phase_nsep(d: int):
    """nsep of the plane wave 2 exp(3it) on [0, 2pi), 2SPLIT4B, main and
    auxiliary spectra against their closed forms (tests/test_nsep.py)."""
    import jax.numpy as jnp

    import fnft_tpu as ft

    t = 2 * np.pi / d * np.arange(d)
    q = jnp.asarray(2.0 * np.exp(3j * t))
    box = (-10.0, 10.0, -10.0, 10.0)
    opts = ft.NsepOpts(filtering=ft.PointFilter.MANUAL, bounding_box=box,
                       discretization=ft.Discretization.SPLIT4B)

    def band_edges(j):
        sq = np.sqrt(4 - j * j / 4.0 + 0j)
        return np.concatenate([-1.5 + 1j * sq, -1.5 - 1j * sq])

    main, aux = band_edges(np.arange(50)), band_edges(np.arange(1, 50))

    def keep(v):
        v = np.asarray(v)
        inbox = ((v.real >= box[0]) & (v.real <= box[1])
                 & (v.imag >= box[2]) & (v.imag <= box[3]))
        # slow convergence at the degenerate points near -1.5 (the
        # reference testcase's remove box)
        near = (np.abs(v.real + 1.5) < 0.1) & (np.abs(v.imag) < 0.1)
        return v[inbox & ~near]

    def hausdorff(a, b):
        dist = np.abs(a[:, None] - b[None, :])
        return float(max(dist.min(axis=1).max(), dist.min(axis=0).max()))

    def run():
        return _result_arrays(ft.nsep(q, (0.0, 2 * np.pi), kappa=+1,
                                      opts=opts))

    def check(out):
        em = hausdorff(keep(out["main_spectrum"]), keep(main))
        ea = hausdorff(keep(out["aux_spectrum"]), keep(aux))
        # fnft_nsep_test_plane_wave_focusing_2split4B.c bounds (D=1024)
        return {"main_spectrum": (em, 9.6e-5), "aux_spectrum": (ea, 4.4e-5)}

    return run, check


def phase_nsev_inverse(d: int):
    """nsev_inverse of alpha/(xi - i beta) plus one bound state, M = 2D.

    Check: the forward transform finds the one bound state, and the
    radiation part of the result (the contspec-only inverse of its forward
    reflection coefficient) survives forward nsev -> nsev_inverse within the
    reference's round-trip bound. The round trip runs at M = 8D: it is
    exact only on an oversampled grid (M = 4D leaves 6e-5 on this signal,
    M = 2D 1e-2)."""
    import jax.numpy as jnp

    import fnft_tpu as ft
    from fnft_tpu.utils.misc import rel_err

    m, t_span = 2 * d, (-2.0, 2.0)
    xi_span = ft.nsev_inverse_xi_grid(d, t_span, m)
    xi = np.linspace(*xi_span, m)
    alpha, beta = 2.0, 0.55
    contspec = jnp.asarray(alpha / (xi - 1j * beta))
    bs = np.array([1j * beta])
    nc = np.array([-1j * alpha / (math.hypot(alpha, beta) + beta)])

    def run():
        return ft.nsev_inverse(contspec, xi_span, d, t_span, kappa=+1,
                               bound_states=bs, normconsts_or_residues=nc)

    def check(q):
        m8 = 8 * d
        xi8 = ft.nsev_inverse_xi_grid(d, t_span, m8)
        opts = ft.NsevOpts(discretization=ft.Discretization.SPLIT2A)

        def fwd(x, states):
            return ft.nsev(x, t_span, m=m8, xi_span=xi8, opts=opts,
                           want_bound_states=states)

        full = fwd(q, True)
        q_rad = ft.nsev_inverse(full.reflection_coefficient, xi8, d, t_span)
        q_rt = ft.nsev_inverse(fwd(q_rad, False).reflection_coefficient,
                               xi8, d, t_span)
        # fnft_nsev_inverse_test_against_forward_focusing_2split2A.c
        return {"roundtrip": (float(rel_err(q_rt, q_rad)), 5.3e-8),
                "n_bound_states": (abs(len(full.bound_states) - 1), 0)}

    return run, check


def repulsion_oracle(z: np.ndarray, block: int = 1024) -> np.ndarray:
    """sum_{j != i} 1/(z_i - z_j) in float64 on the host, by brute force."""
    out = np.empty_like(z)
    for s in range(0, z.size, block):
        diff = z[s:s + block, None] - z[None, :]
        rows = np.arange(diff.shape[0])
        diff[rows, s + rows] = np.inf          # 1/inf = 0: self excluded
        out[s:s + block] = np.sum(1.0 / diff, axis=1)
    return out


def phase_repulsion(degs):
    """The Aberth repulsion of ops.roots (complex64 sums) at each degree."""
    import jax
    import jax.numpy as jnp

    from fnft_tpu.ops.roots import _repulsion_chunked

    rng = np.random.default_rng(0)
    zs = [rng.normal(size=n) + 1j * rng.normal(size=n) for n in degs]
    fn = jax.jit(lambda z: _repulsion_chunked(z, z, jnp.arange(z.shape[0])))
    zj = [jnp.asarray(z) for z in zs]

    def run():
        return [fn(z) for z in zj]

    def check(outs):
        # float32 reciprocals and sums: agreement to f32 accumulation noise
        return {f"deg_{n}": (_rel(o, repulsion_oracle(z)), 1e-5)
                for n, z, o in zip(degs, zs, outs)}

    return run, check


def phase_df64_legacy(d: int):
    """The float32-pair tier (nsev_fullspec_tpu) at SECH_FOCUSING. On a GPU
    it must refuse with ComplexFreeTierUnavailableError (its programs did
    not finish compiling within 300 s on an H100); elsewhere its contspec
    must match the c128 driver's."""
    import jax
    import jax.numpy as jnp

    import fnft_tpu as ft
    from fnft_tpu.errors import ComplexFreeTierUnavailableError
    from fnft_tpu.testcases import NsevTestcase, nsev_testcase

    data = nsev_testcase(NsevTestcase.SECH_FOCUSING, d)

    def run():
        return ft.nsev_fullspec_tpu(data.q, data.t_span, m=data.m,
                                    xi_span=data.xi_span)

    if jax.default_backend() == "gpu":
        def refused():
            try:
                run()
            except ComplexFreeTierUnavailableError:
                return True
            return False

        return refused, lambda ok: {"refused_on_gpu": (int(not ok), 0)}

    def check(out):
        ref = ft.nsev(jnp.asarray(data.q), data.t_span, m=data.m,
                      xi_span=data.xi_span, want_bound_states=False)
        return {"contspec_vs_c128": (
            _rel(out["rho"], ref.reflection_coefficient), 1e-11)}

    return run, check


def phase_multi_batch(d: int, batch: int, n_dev: int):
    """make_nsev_batch_fn sharded over n_dev devices against one device."""
    import jax

    from fnft_tpu.parallel.sharding import make_mesh

    devs = jax.devices()[:n_dev]
    run, _ = phase_nsev_batch(d, batch, mesh=make_mesh(devs))
    one, _ = phase_nsev_batch(d, batch)

    def check(rho):
        return {"sharded_vs_one_device": (_rel(rho, one()), 1e-10)}

    return run, check


def phase_multi_dshard(d: int, n_dev: int):
    """parallel.dshard contspec of 3.2i sech(t), D = M, on a ("seq",) mesh
    against the one-device ft.nsev result."""
    import jax
    from jax.sharding import Mesh

    from fnft_tpu.parallel.dshard import make_dshard_contspec

    devs = jax.devices()[:n_dev]
    fn = make_dshard_contspec(d, (-25.0, 25.0), d, (-2.0, 2.0),
                              Mesh(np.asarray(devs), ("seq",)))
    q = 3.2j / np.cosh(np.linspace(-25.0, 25.0, d))
    one, _ = phase_nsev_rho(d)

    def run():
        return fn(q)["rho"]

    def check(rho):
        return {"dshard_vs_one_device": (_rel(rho, one()), 1e-9)}

    return run, check


# name -> (builder, full-size kwargs, tiny kwargs for the CPU rehearsal)
PHASES = {
    "nsev_rho_2p20": (phase_nsev_rho, dict(d=1 << 20), dict(d=1 << 14)),
    "nsev_full_4096": (phase_nsev_full, dict(d=4096), dict(d=4096)),
    "nsev_full_2p16": (phase_nsev_full, dict(d=1 << 16), dict(d=1024)),
    "nsev_batch_4096": (phase_nsev_batch, dict(d=4096, batch=256),
                        dict(d=256, batch=4)),
    "kdvv_2p17": (phase_kdvv, dict(d=1 << 17), dict(d=1024)),
    "nsep_2p14": (phase_nsep, dict(d=1 << 14), dict(d=1024)),
    "nsev_inverse_2p14": (phase_nsev_inverse, dict(d=1 << 14),
                          dict(d=1024)),
    "repulsion": (phase_repulsion, dict(degs=(1 << 12, 1 << 14)),
                  dict(degs=(300, 1500))),
    "df64_legacy_4096": (phase_df64_legacy, dict(d=4096), dict(d=256)),
}
MULTI_PHASES = {
    "multi_nsev_batch_4096": (phase_multi_batch,
                              dict(d=4096, batch=1024, n_dev=4),
                              dict(d=256, batch=8, n_dev=4)),
    "multi_dshard_rho_2p20": (phase_multi_dshard, dict(d=1 << 20, n_dev=4),
                              dict(d=1 << 12, n_dev=4)),
}


def measure(name: str, builder, kwargs: dict, reps: int = REPS) -> dict:
    """Build, time and check one phase. Returns its record; the record's
    ``failed`` lists every check outside its bound."""
    from jax import block_until_ready

    run, check = builder(**kwargs)
    t0 = time.perf_counter()
    out = block_until_ready(run())
    cold = time.perf_counter() - t0
    warm = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = block_until_ready(run())
        dt = time.perf_counter() - t0
        warm = dt if warm is None else min(warm, dt)
    checks = check(out)
    return {"phase": name, "size": {k: list(v) if isinstance(v, tuple) else v
                                    for k, v in kwargs.items()},
            "cold_s": cold, "warm_s": warm,
            "errors": {k: e for k, (e, _) in checks.items()},
            "bounds": {k: b for k, (_, b) in checks.items()},
            "failed": sorted(k for k, (e, b) in checks.items()
                             if not e <= b)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded phases")
    ap.add_argument("--phase", action="append", default=None,
                    help="run only this phase (repeatable)")
    args = ap.parse_args(argv)

    import jax

    import fnft_tpu as ft
    from fnft_tpu.config import enable_compilation_cache
    from fnft_tpu.utils.device import card_info, peak_bytes_in_use, require_gpu

    ft.use_x64()
    enable_compilation_cache()
    dev = require_gpu()
    n_need = 4 if args.multi else 1
    if len(jax.devices()) < n_need:
        raise SystemExit(f"{n_need} GPUs required, found {len(jax.devices())}")
    card = card_info()
    table = MULTI_PHASES if args.multi else PHASES
    names = args.phase or list(table)
    for name in names:
        builder, full, _ = table[name]
        rec = measure(name, builder, full)
        rec.update(device_kind=dev.device_kind, card=card,
                   peak_bytes_in_use=[peak_bytes_in_use(d)
                                      for d in jax.devices()[:n_need]])
        print(json.dumps(rec), flush=True)
        if rec["failed"]:
            raise SystemExit(f"phase {name} outside its bound: "
                             f"{rec['failed']}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
