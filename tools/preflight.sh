#!/bin/sh
# CPU preflight: the checks a change should pass here, in order of cost.
# Usage: sh tools/preflight.sh [--full]
# The GPU run is chip_smoke.py on a machine with a card (see README).
set -e
cd "$(dirname "$0")/.."
export JAX_PLATFORMS=cpu
echo "== graft entry compile-check"
timeout 300 python -c "
import __graft_entry__ as g
fn, args = g.entry()
import jax
jax.block_until_ready(jax.jit(fn)(*args))
print('entry ok (backend: %s)' % jax.default_backend())"
echo "== 8-device dryrun"
XLA_FLAGS="--xla_force_host_platform_device_count=8" timeout 900 python -c "
import __graft_entry__ as g
g.dryrun_multichip(8)
print('dryrun ok')"
echo "== bench smoke (CPU, small)"
python bench.py --log2d 12 --reps 1 --batch 4
if [ "$1" = "--full" ]; then
    echo "== full suite"
    python -m pytest tests/ -q
    echo "== gated slow tests"
    FNFT_SLOW_TESTS=1 python -m pytest \
        tests/test_scatter_chunked.py::test_full_spectrum_d_2pow16 \
        tests/test_df64.py::test_df64_contspec_at_scale_d_2pow16 \
        tests/test_roots_scale.py -q
fi
echo "PREFLIGHT OK"
