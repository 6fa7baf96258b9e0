#!/usr/bin/env bash
# CI smoke gate for the PyTorch port (src/repro_torch): its tests, every
# examples/torch_*.py end to end, and the obs and static-analysis gates.
#
#   scripts/torch_ci.sh            # on the CPU: tests/test_torch_*.py (against the
#                                  # JAX package), examples and gates with --device cpu
#   scripts/torch_ci.sh --fast     # the same, skipping slow (subprocess / multi-rank) tests
#   scripts/torch_ci.sh --cuda     # on a machine with a card: the card tests (-m cuda),
#                                  # examples and gates with --device cuda
#
# The benchmark gates of scripts/ci.sh (benchmarks.run, bench_trend.py) wait
# for the port's own benchmark and are not run here.
set -euo pipefail
cd "$(dirname "$0")/.."

export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

DEVICE=cpu
PYTEST_ARGS=(-x -q)
for arg in "$@"; do
    case "$arg" in
        --fast) PYTEST_ARGS+=(-m "not slow") ;;
        --cuda) DEVICE=cuda ;;
        *) echo "usage: $0 [--fast] [--cuda]" >&2; exit 2 ;;
    esac
done

if [[ "$DEVICE" == cuda ]]; then
    # the kernels against their plain versions on the card (no JAX needed)
    python -m pytest -q -m cuda tests/test_torch_cuda.py
else
    # the port against the JAX package, phase by phase, bit for bit
    python -m pytest "${PYTEST_ARGS[@]}" tests/test_torch_*.py
fi

# examples smoke gate: every port example runs end to end through the public
# facade; the port's own DeprecationWarnings (messages start "repro_torch:")
# escalate to errors, so a call site that regressed onto a deprecated entry
# point fails here
EXAMPLES_WORKDIR="$(mktemp -d)"
trap 'rm -rf "$EXAMPLES_WORKDIR"' EXIT
for ex in examples/torch_*.py; do
    echo "## example smoke: $ex --device $DEVICE"
    case "$ex" in
        examples/torch_train_lm.py)
            python -W "error:repro_torch:DeprecationWarning" "$ex" --smoke \
                --device "$DEVICE" --workdir "$EXAMPLES_WORKDIR/train" ;;
        *)
            python -W "error:repro_torch:DeprecationWarning" "$ex" --smoke \
                --device "$DEVICE" ;;
    esac
done

# observability gate: span trees on every backend the device runs (direct +
# ticket routes), metric names inside METRIC_CATALOG, stream-edit spans and
# counters, the fleet's program count by buckets, the analyzer's counters
python scripts/torch_obs_smoke.py --device "$DEVICE"

# static-analysis gate: the phase-program lint over every backend the device
# runs, seeded f64 / .item() / non-pow2 violations caught, the fleet's
# program count O(#buckets), backend="auto" bit-identical to its choice
python scripts/torch_analyze_gate.py --device "$DEVICE"
