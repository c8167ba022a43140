"""The check that nothing of JAX is loaded: names compared by their whole
top-level part, and a run with a planted ``import jax`` that must stop."""

import os
import re
import subprocess
import sys

import checkout
from benchlib import guard

HERE = os.path.dirname(os.path.abspath(__file__))


def test_top_level_names_compared_whole():
    assert guard.forbidden_modules(["icl_speech_text_llm_tpu_torch", "numpy"]) == []
    assert guard.forbidden_modules(["icl_speech_text_llm_tpu_torch.models.llama"]) == []
    assert guard.forbidden_modules(["jax.numpy"]) == ["jax"]
    assert guard.forbidden_modules(["icl_speech_text_llm_tpu.models", "optax"]) == [
        "icl_speech_text_llm_tpu", "optax"]
    assert guard.forbidden_modules(["jaxtyping", "flaxen", "orbaxx"]) == []


def test_a_planted_jax_stops_the_run(tmp_path):
    root = checkout.make(str(tmp_path), [("tiny.text", "qwen2a-tiny.json", "tiny-eval-text.json",
                                          {"max_logit_gap": 1e-3})])
    proc = subprocess.run([sys.executable, os.path.join(HERE, "cpu_run.py"), root, "jax",
                           "--workload", "tiny.text", "--seed", "5", "--seconds", "1"],
                          capture_output=True, text=True, timeout=600, cwd=HERE)
    assert proc.returncode != 0
    assert "jax" in proc.stderr.splitlines()[-1]
    assert '"correct"' not in proc.stdout


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(checkout.BENCH, "reference")
    names = [os.path.join(d, n) for d, _, files in os.walk(ref) for n in files if n.endswith(".py")]
    assert os.path.join(ref, "families", "qwen2_audio.py") in names
    for name in names:
        with open(name) as f:
            text = f.read()
        assert "icl_speech_text_llm_tpu" not in text and "import jax" not in text, name
        assert not re.search(r"^\s*(from|import) benchlib", text, re.M), name


def test_a_run_without_the_port_fails(tmp_path):
    root = checkout.make(str(tmp_path), [("tiny.text", "qwen2a-tiny.json", "tiny-eval-text.json",
                                          {"max_logit_gap": 1e-3})])
    proc = subprocess.run([sys.executable, os.path.join(root, "bench_port", "run.py"),
                           "--workload", "tiny.text", "--seed", "5", "--seconds", "1"],
                          capture_output=True, text=True, timeout=600, cwd=root)
    assert proc.returncode != 0 and '"correct"' not in proc.stdout
