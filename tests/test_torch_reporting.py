"""The port's result persistence and error analysis against the JAX
package's ``evaluation/reporting.py`` and ``cli/reprocess.py``, for every
task: ``analyze_errors`` (both branches and the error dict),
``reprocess_results``, the reprocess CLI's printed JSON and ``--out`` file,
and ``save_evaluation_results`` / ``to_json_compatible``."""

import json
import os

import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu import evaluation as jeval
from icl_speech_text_llm_tpu.cli import reprocess as jreprocess
from icl_speech_text_llm_tpu.registry import DatasetType as JDatasetType
from icl_speech_text_llm_tpu_torch import evaluation as teval
from icl_speech_text_llm_tpu_torch.cli import reprocess as treprocess
from icl_speech_text_llm_tpu_torch.registry import DatasetType

from test_torch_metrics import _approx_equal, _random_pairs

torch.set_num_threads(1)
TASKS = list(DatasetType)


def _json(obj):
    return json.loads(json.dumps(jeval.to_json_compatible(obj)))


def _label_lists(pairs, dt):
    """(true, pred) of a batch as analyze_errors gets them: comma-split lists
    for the multi-label HVB tasks, strings for the others."""
    if dt.value.startswith("hvb"):
        split = [([x.strip() for x in g.split(",") if x.strip()],
                  [x.strip() for x in p.split(",") if x.strip()]) for g, p in pairs]
        return [g for g, _ in split], [p for _, p in split]
    return [g for g, _ in pairs], [p for _, p in pairs]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dt", TASKS, ids=lambda d: d.value)
def test_analyze_errors_matches_jax(dt, seed):
    true, pred = _label_lists(_random_pairs(dt, seed), dt)
    got = teval.analyze_errors(true, pred, dt)
    want = jeval.analyze_errors(true, pred, JDatasetType(dt.value))
    assert got == want
    if dt.value.startswith("hvb"):
        assert "common_missing_labels" in got
    else:
        assert "common_confusions" in got


@pytest.mark.parametrize("dt", [DatasetType.HVB, DatasetType.VOXCELEB], ids=lambda d: d.value)
def test_analyze_errors_error_dict_matches_jax(dt):
    for true, pred in (([], []), ([["a"]], [{"b"}])):  # no labels; unhashable list in a set
        got = teval.analyze_errors(true, pred, dt)
        assert got == jeval.analyze_errors(true, pred, JDatasetType(dt.value))
    assert set(teval.analyze_errors([], [], dt)) == {"error", "num_errors", "error_rate"}


def _results_file(tmp_path, dt, seed, wrapped):
    rows = [{"text": f"t{i}", "true_label": g, "predicted_label": p,
             "cleaned_prediction": p, "dataset_type": dt.value}
            for i, (g, p) in enumerate(_random_pairs(dt, seed))]
    path = str(tmp_path / f"{dt.value}_results.json")
    with open(path, "w") as f:
        json.dump({"results": rows, "perf": {}} if wrapped else rows, f)
    return path


@pytest.mark.parametrize("dt", TASKS, ids=lambda d: d.value)
def test_reprocess_results_and_cli_match_jax(tmp_path, capsys, dt):
    for seed, wrapped in ((0, True), (1, False)):
        path = _results_file(tmp_path, dt, seed, wrapped)
        got = teval.reprocess_results(path, dt)
        _approx_equal(got, _json(jeval.reprocess_results(path, JDatasetType(dt.value))))
    printed, outs = [], []
    for cli, side in ((jreprocess, "jax"), (treprocess, "port")):
        out = str(tmp_path / side / "rescored.json")
        cli.main(["--results", path, "--dataset_type", dt.value, "--out", out])
        printed.append(json.loads(capsys.readouterr().out))
        with open(out) as f:
            outs.append(json.load(f))
    _approx_equal(printed[1], printed[0])
    assert not any(isinstance(v, (list, dict)) for v in printed[1].values())
    _approx_equal(outs[1], outs[0])


def test_save_evaluation_results_writes_the_same_json_as_jax(tmp_path):
    metrics = {"accuracy": np.float32(0.5), "n": np.int64(3), "scores": np.arange(3.0),
               "nested": {"pair": (np.float64(1.25), [np.int32(2)])}, "name": "x"}
    got = teval.save_evaluation_results(metrics, str(tmp_path / "t"), "m.json")
    want = jeval.save_evaluation_results(metrics, str(tmp_path / "j"), "m.json")
    assert os.path.basename(got) == os.path.basename(want) == "m.json"
    with open(got) as f, open(want) as g:
        assert f.read() == g.read()
    assert teval.to_json_compatible(metrics) == jeval.to_json_compatible(metrics)
