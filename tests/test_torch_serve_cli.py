"""The port's serving CLI against the JAX package's, one counterpart for
each test of ``tests/test_serve_cli.py``, plus the CLI with
``--lora_bank``, ``--chunk_len`` and ``--kv_int8`` on the CPU and the
flags it refuses.

Both CLIs run salmonn-tiny on the same synthetic voxceleb requests; the
port's model gets the JAX model's weights (``create_model`` patched to
bridge them), so every request's tokens must be identical. salmonn-tiny
computes in f32 in both, so the port's engine (the model's compute dtype)
and JAX's (f32) are the same.
"""

import json

import jax
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.cli import serve as jserve
from icl_speech_text_llm_tpu.models import factory as jfactory
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.cli import serve as tserve
from icl_speech_text_llm_tpu_torch.models import factory as tfactory
from icl_speech_text_llm_tpu_torch.training.checkpoint import save_checkpoint

torch.set_num_threads(1)
BASE = ["--model_type", "salmonn-tiny", "--dataset_type", "voxceleb", "--synthetic",
        "--max_samples", "3", "--num_slots", "2", "--max_new_tokens", "4"]
PLAIN = BASE + ["--num_examples", "1"]
PREFIX = BASE + ["--num_examples", "2", "--fewshot_mode", "speech", "--shared_prefix",
                 "--prompt_buckets", "128,256", "--prefix_buckets", "512"]


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(np.asarray, jfactory.create_model("salmonn-tiny", seed=42).params)


@pytest.fixture
def bridged(monkeypatch, jax_params):
    """The port CLI's model with the JAX model's weights; → its models."""
    models = []

    def create(*a, **kw):
        model = tfactory.create_model(*a, **kw)
        model.params = model.engine.params = params_from_numpy(jax_params, device="cpu")
        models.append(model)
        return model

    monkeypatch.setattr(tserve, "create_model", create)
    return models


def _run(main, argv, capsys):
    results = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return results, out


def _check_summary(out, n):
    summary = json.loads(out[-1])
    assert summary["requests"] == n and summary["throughput_req_s"] > 0
    assert sum(1 for line in out if line.startswith("[req ")) == n
    return summary


def test_serve_cli_salmonn(capsys, bridged):
    want, jout = _run(jserve.main, PLAIN, capsys)
    got, out = _run(tserve.main, PLAIN + ["--device", "cpu"], capsys)
    assert len(got) == 3 and got == want
    summary = _check_summary(out, 3)
    assert summary["decode_blocks"] > 0 and summary["prefill_waves"] == 2  # 2 slots
    assert [l for l in out if l.startswith("[req ")] == [l for l in jout if l.startswith("[req ")]


def test_serve_cli_shared_prefix(capsys, bridged):
    """--shared_prefix: the exemplar header registered once as prefix KV,
    each request prefilling only its query suffix."""
    want, _ = _run(jserve.main, PREFIX, capsys)
    got, out = _run(tserve.main, PREFIX + ["--device", "cpu"], capsys)
    assert len(got) == 3 and got == want
    assert _check_summary(out, 3)["prefix_len"] > 128


def test_serve_cli_lora_bank_chunked_kv_int8(capsys, bridged, tmp_path, jax_params):
    """Two trainable checkpoints written by the port stacked into a bank,
    requests cycling over it, chunked admission into the int8 pool; JAX's
    CLI reads the same checkpoints (the chunk prefills attend the
    dequantized cache in both packages)."""
    dirs = []
    for i, scale in enumerate((1.0, -0.5)):
        lora = {name: {"a": leaf["a"], "b": leaf["b"] + 0.02 * scale}
                for name, leaf in jax_params["lora"].items()}
        dirs.append(str(tmp_path / f"d{i}"))
        save_checkpoint(dirs[-1], {"lora": params_from_numpy(lora, device="cpu")})
    argv = PLAIN + ["--lora_bank", ",".join(dirs), "--chunk_len", "128", "--kv_int8"]
    want, _ = _run(jserve.main, argv, capsys)
    got, out = _run(tserve.main, argv + ["--device", "cpu"], capsys)
    assert len(got) == 3 and got == want
    summary = _check_summary(out, 3)
    assert summary["chunk_dispatches"] >= 2
    (model,) = bridged
    llm = model.cfg.llm  # int8 k and v, f32 scales; 2 slots + scratch, 640 positions
    assert summary["pool_bytes"] == 2 * llm.n_layers * 3 * llm.n_kv_heads * 640 * (llm.hd + 4)


def test_serve_cli_refuses_what_is_not_ported():
    with pytest.raises(SystemExit):
        tserve.main(PLAIN + ["--compile_cache", "/nonexistent", "--device", "cpu"])
    # --mesh is ported: a mesh of one serves (a group of one, gone after)
    assert len(tserve.main(PLAIN + ["--mesh", "1,1,1", "--device", "cpu"])) > 0
    assert not torch.distributed.is_initialized()
    with pytest.raises(SystemExit):
        tserve.main(PLAIN + ["--mesh", "1,1", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tserve.main(PREFIX + ["--num_beams", "2", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tserve.main(PREFIX + ["--lora_bank", "a,b", "--device", "cpu"])
    assert tserve.build_parser().get_default("device") == "cuda"
