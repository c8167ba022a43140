"""The port must import on a machine that has torch but no jax, optax,
orbax, pandas, sklearn or nltk (the machine with the GPU has none of them)
and no safetensors (the port reads and writes that format itself), and it
imports nothing of the JAX package ``icl_speech_text_llm_tpu``, not even
its modules that need no jax."""

import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "icl_speech_text_llm_tpu_torch")
BLOCKED = ("jax", "jaxlib", "optax", "orbax", "pandas", "sklearn", "nltk", "safetensors",
           "icl_speech_text_llm_tpu")
#: modules the walk must reach (the training and quantized slices' among them)
REQUIRED = ("training.step", "training.loop", "training.schedulers", "training.checkpoint",
            "cli.train", "data.pipeline", "ops.flash_attention", "models.salmonn",
            "ops.quant", "ops.int4_matmul", "inference.beam", "registry",
            "utils.tokenization", "evaluation.reporting", "cli.reprocess", "cli.convert",
            "utils.safetensors_np", "models.stream_convert", "models.convert",
            "models.synth_ckpt", "models.base", "models.factory", "cli.inference",
            "inference.serving", "cli.serve", "models.qwen_audio",
            "symbol_adapter", "symbol_adapter.configs", "symbol_adapter.schedulers",
            "symbol_adapter.symbol_manager", "symbol_adapter.mlp_adapter",
            "symbol_adapter.losses", "symbol_adapter.trainer", "symbol_adapter.validation",
            "symbol_adapter.orchestrator", "cli.symbol_train", "cli.symbol_inference",
            "cli.interactive", "models.multi_task", "utils.perf", "utils.memory",
            "utils.logging_utils", "config", "config.static_configs",
            "data.fewshot_retrieval", "parallel", "parallel.multihost", "parallel.mesh",
            "parallel.sharding", "parallel.collectives", "parallel.pipeline",
            "parallel.ring_attention", "parallel.sequence_parallel")

_CHILD = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = %r

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

for mod in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[mod]  # anything a site hook loaded must be found again
sys.meta_path.insert(0, Blocker())
import icl_speech_text_llm_tpu_torch as port

names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
missing = [r for r in %r if port.__name__ + "." + r not in names]
assert not missing, missing
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def test_every_port_module_imports_without_jax_pandas_sklearn_nltk():
    out = subprocess.run([sys.executable, "-c", _CHILD % (BLOCKED, REQUIRED)], cwd=REPO,
                         env={**os.environ, "PYTHONPATH": REPO}, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) >= 33


def test_no_jax_import_statement_in_the_port():
    pattern = re.compile(r"^\s*(import|from) jax")
    hits = []
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    hits += [f"{path}:{i}" for i, line in enumerate(fh, 1) if pattern.match(line)]
    assert not hits, hits
