"""The whole run of a tiny cell on the CPU, the port against the plain
reference at tiny widths: ``correct`` is true as the port stands, and
false with each fault the cell can have planted under the timed path."""

import json
import os
import subprocess
import sys

import pytest

import checkout

HERE = os.path.dirname(os.path.abspath(__file__))
EVAL_LIMITS = {"max_logit_gap": 1e-3}
TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-3}
CELLS = {
    "tiny.speech": ("qwen2a-tiny.json", "tiny-eval-speech.json", EVAL_LIMITS),
    "tiny.text": ("qwen2a-tiny.json", "tiny-eval-text.json", EVAL_LIMITS),
    "tiny-int4kv8.speech": ("qwen2a-tiny-int4kv8.json", "tiny-eval-speech.json", EVAL_LIMITS),
    "tiny-int8kv8.speech": ("qwen2a-tiny-int8kv8.json", "tiny-eval-speech.json", EVAL_LIMITS),
    "tiny.train": ("qwen2a-tiny.json", "tiny-train.json", TRAIN_LIMITS),
}
#: a family added from files alone: Qwen2-Audio's modules under another name
THROWAWAY = ("throwaway", "throwaway_family.py", "throwaway_family_reference.py")


def run_cell(tmp_path, cell, fault="none", seed=3000000017, trace=0, files=None, families=()):
    cfg, traffic, limits = files or CELLS[cell]
    root = checkout.make(str(tmp_path), [(cell, cfg, traffic, limits)], families)
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "cpu_run.py"), root, fault, "--workload", cell,
         "--seed", str(seed), "--seconds", "1", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=HERE)
    lines = proc.stdout.strip().splitlines()
    return proc, (json.loads(lines[-1]) if proc.returncode == 0 and lines else None)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_port_matches_reference(tmp_path, cell):
    proc, line = run_cell(tmp_path, cell)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert line["correct"] is True, line
    assert line["failed"] == 0
    assert list(line)[-1] == "checks"
    last = proc.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(l.startswith("check ") for l in last), last


def test_a_family_added_from_files_alone_runs(tmp_path):
    proc, line = run_cell(tmp_path, "throwaway.speech",
                          files=("throwaway-tiny.json", "tiny-eval-speech.json", EVAL_LIMITS),
                          families=[THROWAWAY])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert line["correct"] is True, line
    assert line["checks"]["max_logit_gap"]["value"] <= EVAL_LIMITS["max_logit_gap"]


@pytest.mark.parametrize("cell,fault", [("tiny.speech", "token"), ("tiny-int8kv8.speech", "token"),
                                        ("tiny.train", "unchanged"), ("tiny.train", "half_batch")])
def test_fault_is_not_correct(tmp_path, cell, fault):
    proc, line = run_cell(tmp_path, cell, fault)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert line["correct"] is False, line


def test_traced_run_reports_per_layer_metrics(tmp_path):
    proc, line = run_cell(tmp_path, "tiny.text", trace=1)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert line["correct"] is True
    assert {"device_idle_pct.eval", "mfu.eval"} <= set(line["metrics"])
    assert "eval_utt_per_s" not in line["metrics"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["window_s"] > 0
