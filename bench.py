"""Headline benchmark: nsev continuous spectrum in complex128.

Config matches BASELINE.md's single-core C anchor: fnft_nsev reflection
coefficient of a sech pulse (A=3.2, T=[-25,25]) with the default 2SPLIT4B
discretization, M = D spectral points. The C reference wall-clock (gcc -O3
-march=native, KissFFT, on the host BASELINE.md names) is:

    D=2^20: 17.82 s   |   D=2^18: 3.185 s   |   D=2^16: 0.718 s

The run times the device JAX runs on and names it; it never falls back to
another. Beside the headline it grades the reference's six-error harness at
D=4096 against the reference's own bounds and times a batch of D=4096
spectra. Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

from chip_smoke import (measure, phase_nsev_batch, phase_nsev_full,
                        phase_nsev_rho)

C_BASELINE_SECONDS = {
    1 << 12: 0.033155,
    1 << 14: 0.152269,
    1 << 16: 0.718106,
    1 << 18: 3.184655,
    1 << 20: 17.816561,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2d", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args(argv)

    import jax

    import fnft_tpu as ft
    from fnft_tpu.config import enable_compilation_cache
    from fnft_tpu.utils.device import card_info

    ft.use_x64()
    enable_compilation_cache()
    dev = jax.devices()[0]
    d = 1 << args.log2d

    head = measure("nsev_rho", phase_nsev_rho, dict(d=d), reps=args.reps)
    harness = measure("nsev_full_4096", phase_nsev_full, dict(d=4096),
                      reps=args.reps)
    batch = measure("nsev_batch_4096", phase_nsev_batch,
                    dict(d=4096, batch=args.batch), reps=args.reps)
    base = C_BASELINE_SECONDS.get(d)
    print(json.dumps({
        "metric": f"nsev_contspec_sech_D{d}_2split4b_c128_seconds",
        "value": head["warm_s"],
        "unit": "s",
        "vs_baseline": base / head["warm_s"] if base else None,
        "accuracy_check_passed": not (head["failed"] or harness["failed"]
                                      or batch["failed"]),
        "errors": head["errors"],
        "harness_errors_D4096": harness["errors"],
        "harness_bounds_D4096": harness["bounds"],
        "batched_D4096_spectra_per_sec": args.batch / batch["warm_s"],
        "compile_seconds": head["cold_s"] - head["warm_s"],
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "card": card_info() if dev.platform == "gpu" else None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
