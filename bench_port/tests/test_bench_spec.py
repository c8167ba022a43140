"""``BENCHMARK.json`` against its contract, and the harness finding each
cell's files by name, its model family's among them; a throwaway cell
added from files alone runs."""

import json
import os
import re

import pytest

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
    c = spec.load(cell)
    assert c.family.mismatches(c.config, c.family.port_config(c.config)) == []
    assert c.config["torch_dtype"] == "bfloat16"


@pytest.mark.parametrize("cell", CELLS)
def test_prompts_fit_their_budget(cell):
    from benchlib import traffic
    from reference.text import Tokenizer

    c, tok = spec.load(cell), Tokenizer()
    t = c.traffic
    for seed in (1, 2 ** 31 + 11):
        gen = traffic.generate(t, seed)
        worst = max(c.reference.prompt_length(t["task"], r, tok) for b in gen.batches for r in b)
        assert worst[0] <= t["seq_len"] - 4 and worst[1] <= t["text_len"] - 4, (cell, worst)


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


def test_a_family_is_found_by_the_name_its_configuration_gives(tmp_path):
    root = checkout.make(str(tmp_path), [("throwaway.family", "throwaway-tiny.json",
                                          "tiny-eval-text.json", {"max_logit_gap": 1e-3})],
                         families=[("throwaway", "throwaway_family.py",
                                    "throwaway_family_reference.py")])
    c = spec.load("throwaway.family", root, os.path.join(root, "bench_port"))
    bench = os.path.join(root, "bench_port")
    assert c.family.__file__ == os.path.join(bench, "benchlib", "families", "throwaway.py")
    assert c.reference.__file__ == os.path.join(bench, "reference", "families", "throwaway.py")
    assert callable(c.family.eval_model) and callable(c.reference.Plain)
    assert c.opmap == spec.load(CELLS[0]).opmap


@pytest.mark.parametrize("side", ["benchlib", "reference"])
def test_a_missing_family_module_is_named(tmp_path, side):
    root = checkout.make(str(tmp_path), [("throwaway.family", "throwaway-tiny.json",
                                          "tiny-eval-text.json", {"max_logit_gap": 1e-3})],
                         families=[("throwaway", "throwaway_family.py",
                                    "throwaway_family_reference.py")])
    missing = os.path.join(root, "bench_port", side, "families", "throwaway.py")
    os.remove(missing)
    with pytest.raises(FileNotFoundError, match=re.escape(missing)):
        spec.load("throwaway.family", root, os.path.join(root, "bench_port"))


def test_a_family_adds_operations_and_redefines_none(tmp_path):
    from benchlib import roofline

    ops = roofline.load_opmap(extra={"gated_attention": ["flash_gated_kernel"]})
    assert ops["gated_attention"] == ["flash_gated_kernel"]
    assert ops["qmatmul"] == roofline.load_opmap()["qmatmul"]
    with pytest.raises(ValueError, match="qmatmul"):
        roofline.load_opmap(extra={"qmatmul": ["any_kernel"]})
