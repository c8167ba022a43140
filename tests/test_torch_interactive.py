"""The port's multi-task router and interactive CLI against the JAX
package's, on salmonn-tiny at f32 on the CPU with the JAX model's weights
bridged into the port's: ``MultiTaskModel`` routes each task's prompt
template and generation parameters and generates what JAX's does; the
REPL prints the same raw and cleaned predictions for piped ``synth`` lines
and wav files, and refuses ``--compile_cache``."""

import io
import sys
import wave

import jax
import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.cli import interactive as jinteractive
from icl_speech_text_llm_tpu.data.collate import ICLSample as JSample
from icl_speech_text_llm_tpu.data.packing import PackConfig as JPackConfig
from icl_speech_text_llm_tpu.data.prompts import build_default_prompt as jprompt
from icl_speech_text_llm_tpu.models import factory as jfactory
from icl_speech_text_llm_tpu.models.multi_task import MultiTaskModel as JMultiTask
from icl_speech_text_llm_tpu_torch.bridge import params_from_numpy
from icl_speech_text_llm_tpu_torch.cli import interactive as tinteractive
from icl_speech_text_llm_tpu_torch.data.collate import ICLSample as TSample
from icl_speech_text_llm_tpu_torch.data.packing import PackConfig as TPackConfig
from icl_speech_text_llm_tpu_torch.data.prompts import build_default_prompt as tprompt
from icl_speech_text_llm_tpu_torch.models import factory as tfactory
from icl_speech_text_llm_tpu_torch.models.multi_task import MultiTaskModel as TMultiTask

torch.set_num_threads(1)
TASKS = {
    "voxceleb": {"prompt_template": "Sentiment: <SpeechHere>", "max_new_tokens": 3},
    "hvb": {"prompt_template": "Acts: <SpeechHere>", "max_new_tokens": 5, "num_beams": 2,
            "repetition_penalty": 1.2, "min_length": 1},
    "plain": {},
}


@pytest.fixture(scope="module")
def models():
    jmodel = jfactory.create_model("salmonn-tiny", seed=0)
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    tmodel = tfactory.create_model("salmonn-tiny", seed=0, device="cpu")
    tmodel.params = tmodel.engine.params = params_from_numpy(params, device="cpu")
    kw = dict(seq_len=512, text_len=256, max_slots=1,
              audio_tokens_per_slot=tmodel.cfg.audio_tokens_per_slot)
    jmodel.pack_cfg, tmodel.pack_cfg = JPackConfig(**kw), TPackConfig(**kw)
    return jmodel, tmodel, params


def _samples(cls, prompt, n=2):
    rng = np.random.RandomState(0)
    plan = prompt("Classify: <SpeechHere>", "", [], input_mode="speech_only",
                  fewshot_mode="text")
    return [cls(plan=plan, completion="", slot_audio={("main", 0): rng.randn(16000)
                                                       .astype(np.float32) * 0.1},
                extras={"dataset_type": "voxceleb"}) for _ in range(n)]


def test_multi_task_model_routes_tasks_as_jax(models):
    jmodel, tmodel, _ = models
    jm = JMultiTask(jmodel, TASKS, default_task="voxceleb")
    tm = TMultiTask(tmodel, TASKS, default_task="voxceleb")
    assert tm.task_prompt_templates == jm.task_prompt_templates
    assert tm.set_task("nope") is jm.set_task("nope") is False
    assert tm.current_task == "voxceleb"
    for task in (None, *TASKS, "nope"):
        assert tm.get_task_prompt_template(task) == jm.get_task_prompt_template(task)
        assert tm.get_task_generation_params(task) == jm.get_task_generation_params(task)
    for task in ("voxceleb", "hvb", "plain"):
        assert tm.set_task(task) is jm.set_task(task) is True
        got = tm.generate_output(_samples(TSample, tprompt))
        want = jm.generate_output(_samples(JSample, jprompt))
        assert got == want, task
        params = tm.get_task_generation_params()
        assert all(getattr(tmodel.engine.gen, k) == v for k, v in params.items())


def test_multi_task_model_delegates_forward():
    class Fake:
        def forward(self, samples):
            return {"loss": len(samples)}

        def generate_output(self, samples):
            return ["x"] * len(samples)

    tm = TMultiTask(Fake(), TASKS)
    assert tm.current_task is None and tm.forward([1, 2]) == {"loss": 2}
    assert tm.generate_output([1]) == ["x"]  # no engine: nothing to configure


def _write_wav(path, sr):
    t = np.arange(sr) / sr
    data = (0.2 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.stack([data, data], 1).tobytes())


def test_interactive_cli_prints_what_jax_prints(models, tmp_path, monkeypatch, capsys):
    _, _, params = models
    wav, npy = tmp_path / "a.wav", tmp_path / "b.npy"
    _write_wav(wav, 8000)
    np.save(npy, np.random.RandomState(1).randn(16000).astype(np.float32) * 0.1)
    lines = f"synth\n{wav}\n{npy}\n/nonexistent.wav\n\nnot read\n"

    def create(*a, **kw):
        model = tfactory.create_model(*a, **kw)
        model.params = model.engine.params = params_from_numpy(params, device="cpu")
        return model

    monkeypatch.setattr(tinteractive, "create_model", create)
    argv = ["--model_type", "salmonn-tiny", "--dataset_type", "voxceleb",
            "--max_new_tokens", "4"]
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    jinteractive.main(argv)
    want = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    tinteractive.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert sum(line.startswith("raw:") for line in got) == 3 and got[-1] == "bye"
    assert any(line.startswith("could not load /nonexistent.wav") for line in got)
    np.testing.assert_array_equal(tinteractive._load_wav("synth"),
                                  jinteractive._load_wav("synth"))
    with pytest.raises(SystemExit):
        tinteractive.main(argv + ["--compile_cache", "/tmp/x"])
