"""The port's three CLIs on qwen2-audio-tiny against the JAX package's, on
the CPU: the same synthetic voxceleb requests in Qwen's chat format, each
clip splicing its ``audio_output_length`` positions, and the port's model
carrying the JAX model's weights (its ``create_model`` patched to bridge
them), all in f32.

- inference: every prediction and every generated token equal to JAX's;
- serve: every request's tokens and printed line equal to JAX's;
- train: 2 steps, each loss within 1e-5 of JAX's, and the LoRA alone
  trained and checkpointed.
"""

import json

import jax
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.cli import inference as jinference
from icl_speech_text_llm_tpu.cli import serve as jserve
from icl_speech_text_llm_tpu.cli import train as jtrain
from icl_speech_text_llm_tpu.models import factory as jfactory
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.cli import inference as tinference
from icl_speech_text_llm_tpu_torch.cli import serve as tserve
from icl_speech_text_llm_tpu_torch.cli import train as ttrain
from icl_speech_text_llm_tpu_torch.models import factory as tfactory
from icl_speech_text_llm_tpu_torch.training import checkpoint as tckpt

torch.set_num_threads(1)
MODEL = ["--model_type", "qwen2-audio-tiny", "--dataset_type", "voxceleb", "--synthetic",
         "--seed", "42"]


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(
        np.asarray, jfactory.create_model("qwen2-audio-tiny", seed=42).params)


def _bridge(monkeypatch, module, jax_params, models):
    """The port CLI ``module``'s model with the JAX model's weights."""

    def create(*a, **kw):
        model = tfactory.create_model(*a, **kw)
        model.params = model.engine.params = params_from_numpy(jax_params, device="cpu")
        models.append(model)
        return model

    monkeypatch.setattr(module, "create_model", create)


def test_inference_cli_predictions_and_tokens_equal_jax(tmp_path, monkeypatch, jax_params):
    argv = MODEL + ["--fewshot_mode", "speech", "--num_examples", "2", "--max_samples", "4",
                    "--batch_size", "2", "--seq_len", "2560", "--text_len", "512",
                    "--max_new_tokens", "6"]
    jtoks = []
    plain_rows = jfactory.QwenAudioModel._decode_rows
    monkeypatch.setattr(jfactory.QwenAudioModel, "_decode_rows",
                        lambda self, toks: jtoks.extend(np.asarray(toks).tolist())
                        or plain_rows(self, toks))
    jpaths = jinference.main(argv + ["--results_dir", str(tmp_path / "j")])
    models = []
    _bridge(monkeypatch, tinference, jax_params, models)
    tpaths = tinference.main(argv + ["--results_dir", str(tmp_path / "t"), "--device", "cpu"])
    want = json.load(open(jpaths["results"]))["results"]
    got = json.load(open(tpaths["results"]))["results"]
    assert len(got) == len(want) == 4
    assert [r["predicted_label"] for r in got] == [r["predicted_label"] for r in want]
    assert [r["tokens"] for r in got] == jtoks
    (model,) = models
    assert isinstance(model, tfactory.QwenAudioModel)
    assert json.load(open(tpaths["metrics"]))["voxceleb"]["total_samples"] == 4


def test_serve_cli_tokens_equal_jax(capsys, monkeypatch, jax_params):
    argv = MODEL + ["--max_samples", "3", "--num_slots", "2", "--max_new_tokens", "4",
                    "--num_examples", "1", "--seq_len", "1024", "--prompt_buckets", "1024"]
    want = jserve.main(argv)
    jout = capsys.readouterr().out.strip().splitlines()
    _bridge(monkeypatch, tserve, jax_params, [])
    got = tserve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(got) == 3 and got == want
    summary = json.loads(out[-1])
    assert summary["requests"] == 3 and summary["decode_blocks"] > 0
    assert [l for l in out if l.startswith("[req ")] == [l for l in jout if l.startswith("[req ")]


def test_train_cli_two_steps_losses_equal_jax(tmp_path, monkeypatch, jax_params):
    argv = MODEL + ["--fewshot_mode", "speech", "--num_examples", "1", "--num_epochs", "1",
                    "--batch_size", "2", "--max_samples", "4", "--seq_len", "2048",
                    "--text_len", "384", "--val_max_samples", "2", "--warmup_steps", "0",
                    "--learning_rate", "1e-3"]
    jlosses = []
    plain_make = jtrain.make_train_step

    def recording(*a, **kw):
        step = plain_make(*a, **kw)

        def run(state, frozen, batch):
            state, metrics = step(state, frozen, batch)
            jlosses.append(float(metrics["loss"]))
            return state, metrics

        return run

    monkeypatch.setattr(jtrain, "make_train_step", recording)
    jtrain.main(argv + ["--output_dir", str(tmp_path / "j")])
    models = []
    _bridge(monkeypatch, ttrain, jax_params, models)
    result = ttrain.main(argv + ["--output_dir", str(tmp_path / "t"), "--device", "cpu"])
    assert result.skipped_batches == 0 and len(result.losses) == len(jlosses) == 2
    np.testing.assert_allclose(result.losses, jlosses, rtol=0, atol=1e-5)
    assert result.losses[0] != result.losses[1]
    assert set(result.state.trainable) == {"lora"}
    saved = tckpt.load_checkpoint(result.checkpoints[0])
    assert set(saved["trainable"]) == {"lora"}
