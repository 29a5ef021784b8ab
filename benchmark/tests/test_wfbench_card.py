"""On the card: a short run of each cell is correct, and the control
(the bf16 color pipeline) fails the check at the cell's own size.
Skips without a CUDA card (decided in the `card` fixture)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import spec

CELLS = [w["name"] for w in spec.load_json(
    os.path.join(spec.ROOT, "BENCHMARK.json"))["workloads"]]


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "2", "--trace", "0"], cwd=spec.ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = last_json(out.stdout)
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/readings.py", "--workload", cell,
         "--seeds", "31", "--control-seeds", "32", "--seconds", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [json.loads(x) for x in out.stdout.splitlines()
            if x.startswith('{"workload"')]
    limits = spec.load_cell(cell).limits
    for row in rows:
        over = any(v > limits[n] for n, v in row["numbers"].items())
        assert over == (row["variant"] == "control"), row
