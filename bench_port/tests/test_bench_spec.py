"""``BENCHMARK.json`` against its contract, and the harness finding each
cell's files by name; a throwaway cell added from files alone runs."""

import json
import os
import re

import pytest
import torch

import checkout
from benchlib import spec

with open(os.path.join(checkout.REPO, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(not p.startswith("/") and ".." not in p for p in BENCH["command"] + BENCH["paths"])
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    c = spec.load(cell)
    assert callable(c.driver.run)
    e2e = {m.name for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert set(c.limits) and all(v > 0 for v in c.limits.values())
    entry = next(x for x in BENCH["configs"] if x["name"] == c.entry["config"])
    assert entry["reduced"] == [] and c.config["name"] == entry["name"]


@pytest.mark.parametrize("cell", CELLS)
def test_config_is_what_the_port_runs(cell):
    from benchlib import portcfg

    cfg = spec.load(cell).config
    pc = portcfg.port_config(cfg)
    a, t = cfg["audio_config"], cfg["text_config"]
    assert (pc.encoder.n_layers, pc.encoder.dim, pc.encoder.n_heads, pc.encoder.n_mels) == (
        a["encoder_layers"], a["d_model"], a["encoder_attention_heads"], a["num_mel_bins"])
    assert (pc.llm.n_layers, pc.llm.dim, pc.llm.n_heads, pc.llm.n_kv_heads, pc.llm.hidden_dim,
            pc.llm.vocab_size, pc.llm.rope_theta, pc.llm.rms_eps, pc.llm.qkv_bias) == (
        t["num_hidden_layers"], t["hidden_size"], t["num_attention_heads"],
        t["num_key_value_heads"], t["intermediate_size"], t["vocab_size"], t["rope_theta"],
        t["rms_norm_eps"], t["qkv_bias"])
    assert pc.pool_stride == cfg["audio_pool_stride"] and pc.compute_dtype == torch.bfloat16


def test_prompts_fit_their_budget():
    from benchlib import traffic
    from reference.check import prompt_length
    from reference.text import Tokenizer

    tok = Tokenizer()
    for name in sorted(os.listdir(os.path.join(checkout.BENCH, "traffic"))):
        with open(os.path.join(checkout.BENCH, "traffic", name)) as f:
            t = json.load(f)
        for seed in (1, 2 ** 31 + 11):
            gen = traffic.generate(t, seed)
            worst = max(prompt_length(t["task"], r, tok) for b in gen.batches for r in b)
            assert worst[0] <= t["seq_len"] - 4 and worst[1] <= t["text_len"] - 4, (name, worst)


def test_every_seed_asks_for_the_same_work():
    from benchlib import traffic

    with open(os.path.join(checkout.BENCH, "traffic", "eval-speech-k5.json")) as f:
        t = json.load(f)
    a, b = traffic.generate(t, 7), traffic.generate(t, 2 ** 33 + 1)
    for x, y in zip(a.batches, b.batches):
        def sizes(batch):
            return sorted(c[1] for r in batch for c in [e.clip for e in r.examples] + [r.main_clip])

        assert sizes(x) == sizes(y)
    assert [r.label for r in a.batches[0]] != [r.label for r in b.batches[0]]


def test_a_throwaway_cell_from_files_alone(tmp_path):
    root = checkout.make(str(tmp_path), [("throwaway.cell", "qwen2a-tiny.json",
                                          "tiny-eval-text.json", {"max_logit_gap": 1e-3})])
    c = spec.load("throwaway.cell", root, os.path.join(root, "bench_port"))
    assert c.traffic["loop"] == "eval" and c.config["name"] == "qwen2a-tiny"
    assert {m.name for m in c.per_layer} >= {"mfu.eval", "device_idle_pct.eval"}
