"""The readings that the harness's layout must not move, pinned to the
numbers the harness gave before each model family had modules of its
own: a tiny cell's checks, work and model flops on the CPU, the tiny
tree bit for bit, the leaf plan of each configuration, and the work of
each cell's first two batches at its real sizes."""

import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

import checkout
from benchlib import roofline, spec, traffic, weights
from reference.text import Tokenizer

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 3000000017

#: (checks, model flops, {operation: (flops, bytes)}) of a window of no time
RUNS = {
    "tiny.speech": (
        {"max_logit_gap": 0.0}, 4265943040.0,
        {"tower_attention": (35481088.0, 631808.0), "prefill_attention": (294377472.0, 1645056.0),
         "decode_attention": (3302400.0, 1657344.0)}),
    "tiny.train": (
        {"loss_gap": 5.920913949924398e-06, "grad_gap": 1.1144627820725599e-05,
         "update_gap": 9.781484998069e-06}, 51735429120.0,
        {"tower_attention": (70962176.0, 1263616.0),
         "train_attention_fwd": (595134464.0, 3308544.0),
         "train_attention_bwd": (1190268928.0, 6617088.0)}),
    "tiny.text": (
        {"max_logit_gap": 0.0}, 1912845312.0,
        {"tower_attention": (11822080.0, 212992.0), "prefill_attention": (178197504.0, 1279488.0),
         "decode_attention": (2571264.0, 1291776.0)}),
    "tiny-int8kv8.speech": (
        {"max_logit_gap": 0.0}, 4265943040.0,
        {"tower_attention": (35481088.0, 631808.0), "prefill_attention": (294377472.0, 1645056.0),
         "decode_attention": (3302400.0, 936288.0), "qmatmul": (79716352.0, 21192832.0)}),
}
CELL_FILES = {
    "tiny.speech": ("qwen2a-tiny.json", "tiny-eval-speech.json"),
    "tiny.train": ("qwen2a-tiny.json", "tiny-train.json"),
    "tiny.text": ("qwen2a-tiny.json", "tiny-eval-text.json"),
    "tiny-int8kv8.speech": ("qwen2a-tiny-int8kv8.json", "tiny-eval-speech.json"),
}

#: the first two batches of each cell at seed 2**31 + 11: model flops, work
BATCHES = {
    "qwen2a-bf16.eval-speech-k5": (932001148305408.0, {
        "decode_attention": (195047718912.0, 195198713856.0),
        "prefill_attention": (13974622437376.0, 43176165376.0),
        "tower_attention": (2669454950400.0, 16982999040.0)}),
    "qwen2a-bf16.eval-text-k5": (364711291650048.0, {
        "decode_attention": (107395153920.0, 107546148864.0),
        "prefill_attention": (4220471738368.0, 23697817600.0),
        "tower_attention": (443644968960.0, 2827878400.0)}),
    "qwen2a-bf16.train-lora-speech-k5": (399491693543424.0, {
        "tower_attention": (669067837440.0, 4247388160.0),
        "train_attention_bwd": (7007199297536.0, 21642608640.0),
        "train_attention_fwd": (3503599648768.0, 10821304320.0)}),
    "qwen2a-int8kv8.eval-speech-k5": (932001148305408.0, {
        "decode_attention": (195047718912.0, 100795613184.0),
        "prefill_attention": (13974622437376.0, 43176165376.0),
        "qmatmul": (4139207622656.0, 131002284032.0),
        "tower_attention": (2669454950400.0, 16982999040.0)}),
}

#: sha256 of each configuration's leaf plan (JSON), and of the tiny
#: fixture's bfloat16 tree at SEED (each leaf's path, then its bytes)
PLAN = "2ebc4cfe8d01d41d1178592e3b7c73937061a19756583bcc19f9c435770baad1"
PLANS = {"bench_port/configs/qwen2a-bf16.json": PLAN,
         "bench_port/configs/qwen2a-int8kv8.json": PLAN}
TINY_TREE = "e91566252da8823970ccb2190fd8b1dc0f4b990a21951176c1021c35cb4b91f8"


def _ops(work):
    return {k: (v["flops"], v["bytes"]) for k, v in work.items()}


@pytest.mark.parametrize("cell", sorted(RUNS))
def test_a_tiny_run_reads_as_before(tmp_path, cell):
    limits = {"max_logit_gap": 1e-3} if "train" not in cell else {
        "loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-3}
    root = checkout.make(str(tmp_path), [(cell, *CELL_FILES[cell], limits)])
    proc = subprocess.run([sys.executable, os.path.join(HERE, "cpu_record.py"), root, cell,
                           str(SEED)], capture_output=True, text=True, timeout=600, cwd=HERE)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    checks, model_flops, work = RUNS[cell]
    assert (got["checks"], got["model_flops"], _ops(got["work"])) == (checks, model_flops, work)


def _digest(parts):
    h = hashlib.sha256()
    for p in parts:
        h.update(p)
    return h.hexdigest()


def test_the_trees_are_drawn_as_before():
    for path, digest in PLANS.items():
        with open(os.path.join(checkout.REPO, path)) as f:
            cfg = json.load(f)
        family, _ = spec.families(cfg["family"])
        assert _digest([json.dumps(family.leaf_plan(cfg)).encode()]) == digest, path
    with open(os.path.join(checkout.FIXTURES, "qwen2a-tiny.json")) as f:
        cfg = json.load(f)
    family, _ = spec.families(cfg["family"])
    plan = family.leaf_plan(cfg)
    tree = weights.make(plan, SEED, "cpu", dtype=torch.bfloat16)
    parts = []
    for path, _, _ in plan:
        node = tree
        for key in path:
            node = node[key]
        parts += ["/".join(path).encode(), node.contiguous().view(torch.uint8).numpy().tobytes()]
    assert _digest(parts) == TINY_TREE


@pytest.mark.parametrize("cell", sorted(BATCHES))
def test_the_work_of_two_batches_is_as_before(cell):
    c = spec.load(cell)
    t, tok = c.traffic, Tokenizer()
    gen = traffic.generate(t, 2 ** 31 + 11)
    work = roofline.Work()
    for i in range(2):
        batch = gen.batch(i)
        clips = [clip[1] for r in batch
                 for clip in [e.clip for e in r.examples if e.clip] + [r.main_clip]]
        lengths = [c.reference.prompt_length(t["task"], r, tok)[0] for r in batch]
        if t["loop"] == "eval":
            c.family.eval_work(c.config, work, clips, lengths, t["max_new_tokens"])
        else:
            positions = [n + len(tok.encode(r.label)) for n, r in zip(lengths, batch)]
            c.family.train_work(c.config, work, clips, positions)
    assert (work.model_flops, _ops(work.as_dict())) == BATCHES[cell]
