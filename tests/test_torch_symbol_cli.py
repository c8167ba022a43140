"""The port's symbol CLIs against the JAX package's, and BASELINE.md config
4 through the port, on salmonn-tiny at f32 on the CPU.

Both CLIs build their worlds with the orchestrator's packing (2048 / 1024);
the port's model and MLP adapter get the JAX CLI's weights (its
``create_model`` and ``init_mlp_adapter`` patched to bridge them), and the
symbol managers of both packages draw from one seed (the CLIs leave the
symbol seed unset, so ``random.Random`` is seeded in both). Then:

- ``cli.symbol_train``: the same schedule, every step's final loss within
  1e-5 relative, the same validation composites, the same ``run_config.json``
  and checkpoints whose leaves agree within 1e-4 × max |leaf| and carry the
  same mappings;
- ``cli.symbol_inference`` on each CLI's own checkpoint: every mode's
  predictions and composite equal, and the results JSON; ``--compile_cache``
  is refused.
BASELINE.md config 4 through the port is ``tests/test_torch_symbol_config4.py``.
"""

import glob
import json
import os
import random
import types

import jax
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.cli import symbol_inference as jinfer
from icl_speech_text_llm_tpu.cli import symbol_train as jtrain
from icl_speech_text_llm_tpu.models import factory as jfactory
from icl_speech_text_llm_tpu.symbol_adapter import mlp_adapter as jmlp
from icl_speech_text_llm_tpu.symbol_adapter import symbol_manager as jsm
from icl_speech_text_llm_tpu.training import checkpoint as jckpt
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.cli import symbol_inference as tinfer
from icl_speech_text_llm_tpu_torch.cli import symbol_train as ttrain
from icl_speech_text_llm_tpu_torch.models import factory as tfactory
from icl_speech_text_llm_tpu_torch.symbol_adapter import orchestrator as torch_orch
from icl_speech_text_llm_tpu_torch.symbol_adapter import symbol_manager as tsm
from icl_speech_text_llm_tpu_torch.training import checkpoint as tckpt

torch.set_num_threads(1)
TRAIN = ["--training_mode", "bypass_mlp_sym", "--dataset_type", "voxceleb",
         "--val_dataset_type", "voxceleb", "--model_type", "salmonn-tiny", "--synthetic",
         "--total_cycles", "1", "--lora_epochs", "1", "--batch_size", "2", "--max_samples", "2",
         "--val_max_samples", "1", "--num_examples", "1"]
INFER = ["--dataset_type", "voxceleb", "--val_dataset_type", "voxceleb", "--model_type",
         "salmonn-tiny", "--synthetic", "--val_max_samples", "1", "--batch_size", "1"]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture
def bridged(monkeypatch):
    """The port's orchestrator builds JAX's salmonn-tiny (seed 0) and JAX's
    adapter (key seed + 1); unseeded symbol managers draw from seed 7."""
    jparams = jax.tree_util.tree_map(np.asarray, jfactory.create_model("salmonn-tiny",
                                                                       seed=0).params)

    def create(*a, **kw):
        model = tfactory.create_model(*a, **kw)
        model.params = model.engine.params = params_from_numpy(jparams, device=kw["device"])
        return model

    def adapter(gen, dim, hidden, device):
        return params_from_numpy(jmlp.init_mlp_adapter(jax.random.PRNGKey(1), dim, hidden),
                                 device=device)

    monkeypatch.setattr(torch_orch, "create_model", create)
    monkeypatch.setattr(torch_orch, "init_mlp_adapter", adapter)
    seeded = types.SimpleNamespace(Random=lambda seed=None: random.Random(7 if seed is None
                                                                         else seed))
    for mod in (jsm, tsm):
        monkeypatch.setattr(mod, "random", seeded)


def test_symbol_train_and_inference_clis_match_jax(bridged, tmp_path, capsys):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jtrain.main(TRAIN + ["--output_dir", jdir])
    got = ttrain.main(TRAIN + ["--output_dir", tdir, "--device", "cpu"])
    assert capsys.readouterr().out.count("completed 1 schedule steps") == 2
    assert got["schedule"] == want["schedule"] and len(got["summaries"]) == 1
    for g, w in zip(got["summaries"], want["summaries"]):
        assert np.isfinite(g["final_loss"])
        assert abs(g["final_loss"] - w["final_loss"]) <= 1e-5 * abs(w["final_loss"])
        assert [e["val"] for e in g["epochs"]] == [e["val"] for e in w["epochs"]]
        assert set(g["epochs"][0]["val"]) == {"no_mlp_symbols", "no_mlp_fresh",
                                              "no_mlp_original"}
    with open(os.path.join(tdir, "run_config.json")) as f, \
            open(os.path.join(jdir, "run_config.json")) as g:
        assert json.load(f) == json.load(g)
    (tck,), (jck,) = glob.glob(os.path.join(tdir, "lora_step0_*")), \
        glob.glob(os.path.join(jdir, "lora_step0_*"))
    assert os.path.basename(tck) == os.path.basename(jck)
    ts, js = tckpt.load_checkpoint(tck), jckpt.load_checkpoint(jck)
    assert ts["meta"]["metadata"] == js["meta"]["metadata"]
    assert ts["meta"]["metadata"]["symbol_mappings"]
    jleaves = _paths(js["trainable"])
    for name, leaf in _paths(ts["trainable"]).items():
        want_leaf = np.asarray(jleaves[name])
        assert leaf.dtype == want_leaf.dtype == np.float32, name
        assert np.abs(leaf - want_leaf).max() <= 1e-4 * np.abs(want_leaf).max(), name

    jout, tout = str(tmp_path / "jax_inf"), str(tmp_path / "port_inf")
    want = jinfer.main(INFER + ["--checkpoint", jck, "--output_dir", jout])
    jlines = capsys.readouterr().out.splitlines()
    got = tinfer.main(INFER + ["--checkpoint", tck, "--output_dir", tout, "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == jlines and len(jlines) == 3
    assert list(got) == list(want)
    for mode in got:
        assert got[mode]["predictions"] == want[mode]["predictions"], mode
        assert len(got[mode]["predictions"]) == 1
        assert got[mode]["composite"] == want[mode]["composite"]
    with open(os.path.join(tout, "symbol_inference_inference_results.json")) as f:
        saved = json.load(f)
    assert saved["no_mlp_symbols"]["predictions"] == got["no_mlp_symbols"]["predictions"]
    with pytest.raises(SystemExit):
        tinfer.main(INFER + ["--checkpoint", tck, "--compile_cache", "/tmp/x"])
