"""``--auto_batch``: the port's ``utils/memory.py`` against the JAX package's,
and both port CLIs' search on the CPU.

JAX asks its compiler how much memory a batch size needs
(``compiled_memory_bytes``); the port runs the probe once and reads the
card's peak allocation (``peak_bytes``). With one stubbed memory function in
place of both, the two packages' ``BatchSizeOptimizer`` must probe the same
sizes in the same order and pick the same size. The CLIs run the real probe
(generation; the train step's forward and backward) through a stub that
measures nothing on the CPU, and the search must leave the trainable leaves
and AdamW's moments bit-identical.
"""

import json

import numpy as np
import pytest
import torch

from icl_speech_text_llm_tpu.utils import memory as jmemory
from icl_speech_text_llm_tpu_torch.cli import inference as tinference
from icl_speech_text_llm_tpu_torch.cli import train as ttrain
from icl_speech_text_llm_tpu_torch.training.step import tree_leaves
from icl_speech_text_llm_tpu_torch.utils import memory as tmemory

torch.set_num_threads(1)


def test_tile_batch_matches_jax():
    rng = np.random.RandomState(0)
    batch = {"a": rng.randint(0, 9, (1, 7)).astype(np.int32),
             "b": rng.randn(1, 3, 5).astype(np.float32),
             "nested": {"c": rng.randn(1, 2).astype(np.float32)},
             "s": 4}  # non-array leaves pass through
    for bs in (1, 3, 6):
        want, got = jmemory.tile_batch(batch, bs), tmemory.tile_batch(batch, bs)
        assert got["s"] == want["s"] == 4
        for k in ("a", "b"):
            assert got[k].dtype == want[k].dtype and got[k].shape == (bs,) + batch[k].shape[1:]
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        np.testing.assert_array_equal(got["nested"]["c"], np.asarray(want["nested"]["c"]))


def _need(bs, base=1000, per=300, oom_from=None):
    """A memory function: ``base + per · bs`` bytes, out of memory from
    ``oom_from`` on (None)."""
    if oom_from is not None and bs >= oom_from:
        return None
    return base + per * bs


CASES = [  # (budget, max_batch, start, oom_from)
    (1000 + 300 * 64, 4096, 1, None),   # the budget fits 64 exactly
    (1000 + 300 * 37, 512, 1, None),    # refinement between 32 and 64
    (1000 + 300 * 5, 64, 1, None),
    (10 ** 9, 48, 1, None),             # everything fits: the ceiling, not a power of 2
    (10 ** 9, 512, 1, 23),              # out of memory from 23 on
    (10 ** 9, 512, 3, 7),               # another start
    (500, 64, 1, None),                 # nothing fits: 0
    (1000 + 300 * 9, 100, 2, 12),
]


@pytest.mark.parametrize("budget,max_batch,start,oom_from", CASES)
def test_search_probes_and_picks_as_jax(monkeypatch, budget, max_batch, start, oom_from):
    seen = {"jax": [], "port": []}

    def jax_bytes(fn, bs):
        seen["jax"].append(bs)
        return _need(bs, oom_from=oom_from)

    def port_bytes(bs):
        seen["port"].append(bs)
        return _need(bs, oom_from=oom_from)

    monkeypatch.setattr(jmemory, "compiled_memory_bytes", jax_bytes)
    make = lambda bs: (bs,)  # noqa: E731
    jpick = jmemory.BatchSizeOptimizer(None, make, memory_budget_bytes=budget,
                                       max_batch=max_batch).find_optimal_batch_size(start)
    tpick = tmemory.BatchSizeOptimizer(None, make, memory_budget_bytes=budget,
                                       max_batch=max_batch, measure=port_bytes,
                                       device="cpu").find_optimal_batch_size(start)
    assert seen["port"] == seen["jax"] and len(seen["jax"]) > 0
    assert tpick == jpick
    if jpick:
        assert _need(jpick, oom_from=oom_from) <= budget


def test_default_budget_and_memory_stats_keys_on_the_cpu():
    stats = tmemory.get_device_memory_stats("cpu")
    assert set(stats) == set(jmemory.get_device_memory_stats())
    assert all(v == 0.0 for v in stats.values())
    # no device limit: 8 GiB, as JAX's
    assert tmemory.BatchSizeOptimizer(None, None, device="cpu").budget == 8 * 1024**3


def test_peak_bytes_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        tmemory.peak_bytes(lambda: None, lambda: (), "cpu")


def _probe_rows(args):
    """The batch size of a probe's arguments: the rows of its batch dict."""
    batch = next(a for a in args if isinstance(a, dict) and "text_tokens" in a)
    return batch["text_tokens"].shape[0]


class _StubMeasure:
    """``peak_bytes`` on the CPU: runs the probe (checking that it leaves the
    train state as it was) and reports 100 MiB a row; out of memory from
    ``oom_from`` rows on, without running."""

    def __init__(self, oom_from):
        self.oom_from = oom_from
        self.sizes = []
        self.state_kept = []

    def __call__(self, fn, make_args, device="cuda"):
        args = make_args()
        bs = _probe_rows(args)
        self.sizes.append(bs)
        if bs >= self.oom_from:
            return None
        state = args[0] if hasattr(args[0], "opt_state") else None
        if state is not None:
            leaves = tree_leaves({"t": state.trainable, "mu": state.opt_state["mu"],
                                  "nu": state.opt_state["nu"]})
            before = [t.detach().clone() for t in leaves]
        fn(*args)
        if state is not None:
            self.state_kept.append(all(torch.equal(a.detach(), b)
                                       for a, b in zip(leaves, before)))
        return 100 * 2**20 * bs


COMMON = ["--model_type", "salmonn-tiny", "--synthetic", "--fewshot_mode", "speech",
          "--num_examples", "1", "--seq_len", "512", "--text_len", "256", "--device", "cpu",
          "--auto_batch", "--auto_batch_max", "4"]


def test_inference_cli_auto_batch_on_cpu(tmp_path, monkeypatch):
    stub = _StubMeasure(oom_from=3)
    monkeypatch.setattr(tmemory, "peak_bytes", stub)
    paths = tinference.main(COMMON + [
        "--synthetic_size", "8", "--max_samples", "5", "--batch_size", "4",
        "--max_new_tokens", "3", "--results_dir", str(tmp_path)])
    # probes 1, 2, 4 (out of memory), then 3 between 2 and 4 (out of memory): 2
    assert stub.sizes == [1, 2, 4, 3]
    results = json.load(open(paths["results"]))
    assert len(results["results"]) == 5 and results["perf"]["batches"] == 3  # 2 + 2 + 1


def test_train_cli_auto_batch_on_cpu_keeps_the_state(tmp_path, monkeypatch):
    stub = _StubMeasure(oom_from=3)
    monkeypatch.setattr(tmemory, "peak_bytes", stub)
    held = {}
    search = tmemory.BatchSizeOptimizer.find_optimal_batch_size

    def checked(self, start=1):
        state = self.make_args(start)[0]
        before = [t.detach().clone() for t in tree_leaves(
            {"t": state.trainable, "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]})]
        pick = search(self, start)
        after = tree_leaves({"t": state.trainable, "mu": state.opt_state["mu"],
                             "nu": state.opt_state["nu"]})
        held["kept"] = all(torch.equal(a.detach(), b) for a, b in zip(after, before))
        held["count"] = (state.step, state.opt_state["count"])
        return pick

    monkeypatch.setattr(tmemory.BatchSizeOptimizer, "find_optimal_batch_size", checked)
    result = ttrain.main(COMMON + [
        "--num_epochs", "1", "--batch_size", "4", "--max_samples", "4",
        "--val_max_samples", "2", "--output_dir", str(tmp_path)])
    assert stub.sizes == [1, 2, 4, 3]
    assert stub.state_kept == [True, True] and held == {"kept": True, "count": (0, 0)}
    # the state was rebuilt at the pick, 2: two steps over 4 samples
    assert result.state.step == 2 and result.perf["examples"] == 4
    assert result.skipped_batches == 0 and all(np.isfinite(result.losses))
