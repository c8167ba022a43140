"""On the card: the control of each cell, the reference in the nearest
precision below the configuration's put in the program's place, fails the
cell's limits while the program passes them, at the cell's own size on one
seed (``calibrate.py`` reads a dozen). Skips without a card.

    python3 -m pytest bench_port/tests/test_bench_card.py -m cuda
"""

import json
import os
import subprocess
import sys

import pytest

import checkout

with open(os.path.join(checkout.REPO, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    seed = 2 ** 31 + 977
    proc = subprocess.run(
        [sys.executable, os.path.join(checkout.BENCH, "calibrate.py"), "--workload", cell,
         "--seeds", str(seed), "--control-seeds", str(seed), "--seconds", "3"],
        capture_output=True, text=True, timeout=1200, cwd=checkout.REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(os.path.join(checkout.BENCH, "limits", cell + ".json")) as f:
        limits = json.load(f)
    assert row["correct"] is True, row
    assert any(row["control"][k] > limits[k] for k in limits), row
