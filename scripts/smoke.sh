#!/usr/bin/env bash
# Smoke run — the cvo_test.sh analog (script/cvo_test.sh:1-7): the main
# path on the GPU (chip_smoke.py: odometry CLI, numerics canaries, the
# moment kernel against its reference), the toy example, and the unit
# suite's fast subset on the CPU.
set -euo pipefail
cd "$(dirname "$0")/.."
python chip_smoke.py
python examples/toy_example.py /tmp/toy_scene_smoke.ply
JAX_PLATFORMS=cpu python -m pytest tests/test_core.py tests/test_se3.py -x -q
