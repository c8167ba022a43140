"""SALMONN's family in the harness: a tiny SALMONN cell on the CPU, the port
against the plain reference (``correct`` as the port stands, not with an
altered token, nor with one norm over both encoders' columns); the
reference's prompt lengths against the port's packing; the leaf plan
against the port's ``init_salmonn`` at 13B, drawn on the meta device;
the configuration against the port's ``salmonn-13b`` preset; the plan's
digest; the work of a batch."""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

import checkout
from benchlib import roofline, spec, traffic
from reference.text import Tokenizer

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "salmonn13b-bf16.eval-speech-k5"
CONFIG = "bench_port/configs/salmonn13b-bf16.json"
TINY = ("salmonn-tiny.speech", "salmonn-tiny.json", "tiny-eval-speech.json",
        {"max_logit_gap": 1e-3})
SEED = 3000000017
#: sha256 of the configuration's leaf plan (JSON)
PLAN = "8610af443a364ed22c8c11029a1c76d3abcd3e9f6ffdc9cb55935ca52ee61456"

#: one norm over both encoders' columns, as the JAX package computes it
JOINT_NORM = """
import sys, dataclasses
sys.path.insert(0, {here!r})
import checkout
from icl_speech_text_llm_tpu_torch.models import qformer
plain = qformer.input_norm
qformer.input_norm = lambda cfg, ln, x: plain(dataclasses.replace(cfg, norm_widths=()), ln, x)
import run
sys.exit(run.main(sys.argv[1:], device="cpu", root={root!r}))
"""


def _run(tmp_path, fault):
    cell = TINY[0]
    root = checkout.make(str(tmp_path), [TINY], [])
    argv = ["--workload", cell, "--seed", str(SEED), "--seconds", "0", "--trace", "0"]
    if fault == "joint_norm":
        cmd = [sys.executable, "-c", JOINT_NORM.format(here=HERE, root=root)]
    else:
        cmd = [sys.executable, os.path.join(HERE, "cpu_run.py"), root, fault]
    proc = subprocess.run(cmd + argv, capture_output=True, text=True, timeout=600, cwd=HERE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_the_tiny_cell_is_correct(tmp_path):
    line = _run(tmp_path, "none")
    assert line["correct"] is True and line["failed"] == 0, line
    assert line["checks"]["max_logit_gap"]["value"] <= TINY[3]["max_logit_gap"]


@pytest.mark.parametrize("fault", ["token", "joint_norm"])
def test_a_fault_is_not_correct(tmp_path, fault):
    line = _run(tmp_path, fault)
    assert line["correct"] is False, line
    assert line["checks"]["max_logit_gap"]["value"] > 100 * TINY[3]["max_logit_gap"]


def test_prompt_lengths_are_what_the_port_packs():
    from icl_speech_text_llm_tpu_torch.data.collate import collate_icl_batch
    from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

    c = spec.load(CELL)
    t = c.traffic
    gen = traffic.generate(t, 2 ** 31 + 11)
    pc = c.family.port_config(c.config)
    tok = Tokenizer()
    for i in range(2):
        batch = gen.batch(i)
        packed = collate_icl_batch(c.family.samples(gen, batch), get_tokenizer(),
                                   c.family.pack_config(t, pc))
        want = [c.reference.prompt_length(t["task"], r, tok) for r in batch]
        assert packed.seq_lengths.tolist() == [p for p, _ in want]
        completions = [len(tok.encode(r.label)) for r in batch]  # packed after the prompt
        assert (packed.text_tokens != 0).sum(axis=1).tolist() == [
            n + m for (_, n), m in zip(want, completions)]
        assert max(p for p, _ in want) <= t["seq_len"]


def _shapes(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _shapes(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v.shape)


def test_the_leaf_plan_is_the_port_tree_at_13b():
    from icl_speech_text_llm_tpu_torch.models.salmonn import init_salmonn, salmonn_13b

    c = spec.load(CELL)
    tree = init_salmonn(salmonn_13b(), torch.Generator(), "meta", torch.bfloat16)
    plan = [(tuple(path), tuple(shape)) for path, shape, _ in c.family.leaf_plan(c.config)]
    assert len(plan) == len(dict(plan))
    assert dict(plan) == dict(_shapes(tree))


def test_the_configuration_is_the_salmonn_13b_preset():
    from icl_speech_text_llm_tpu_torch.models.salmonn import salmonn_13b

    c = spec.load(CELL)
    pc = c.family.port_config(c.config)
    assert c.family.mismatches(c.config, pc) == []
    preset = salmonn_13b()
    assert pc.llm.max_seq_len == 2048  # the file's; the preset's field is read by nothing
    assert dataclasses.replace(pc, llm=dataclasses.replace(pc.llm, max_seq_len=4096)) == preset
    assert pc.audio_tokens_per_slot == 88 and pc.qformer.norm_widths == (1280, 768)


def test_the_tree_is_drawn_as_pinned():
    with open(os.path.join(checkout.REPO, CONFIG)) as f:
        cfg = json.load(f)
    family, _ = spec.families(cfg["family"])
    digest = hashlib.sha256(json.dumps(family.leaf_plan(cfg)).encode()).hexdigest()
    assert digest == PLAN


def test_the_work_of_a_batch():
    """96 clips: each ≈2.64 TFLOP of encoders (Whisper ≈2.27, BEATs ≈0.35,
    the Q-Former ≈0.02); K3 the 4·64·12 flops of each of 1496² pairs a
    layer, and the bias table read once a layer."""
    c = spec.load(CELL)
    fam = c.family
    w = roofline.Work()
    fam.encoders(c.config, w, 96)
    per_clip = w.model_flops / 96
    assert 2.55e12 < per_clip < 2.75e12
    beats = w.ops["beats_attention"]
    pairs = 96 * 12 * 1496 ** 2
    assert 4 * 64 * 12 * pairs < beats[0] < 1.01 * 4 * 64 * 12 * pairs
    clips_bytes = 96 * 12 * 5 * 1496 * 768 * 2  # q, k, v, o and the gate's input
    assert beats[1] == clips_bytes + 12 * 12 * 1496 ** 2 * 2
    whisper = w.ops["tower_attention"]
    assert whisper[0] == 96 * 32 * 4 * 64 * 20 * 1500 ** 2
