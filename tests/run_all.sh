#!/bin/sh
# Run the ENTIRE test suite (fast tier, then slow tier + fuzz) on the CPU.
# GPU-marked tests skip here; chip_smoke.py runs the same checks on the card.
#
# Usage:  sh tests/run_all.sh            (from anywhere)
#         PYTHON=python3.12 sh tests/run_all.sh
set -e
cd "$(dirname "$0")/.."
PY="${PYTHON:-python}"

echo "=== tier 1/2: fast (everything not marked slow/fuzz) ==="
"$PY" -m pytest -q tests/ -m "not slow and not fuzz"

echo "=== tier 2/2: slow + property fuzzing ==="
"$PY" -m pytest -q tests/ -m "slow or fuzz"

echo "ALL TIERS GREEN"
