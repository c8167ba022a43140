"""The ICL evaluation loop: batches back to back (a closed loop) through the
port's prompt builder, ``collate_icl_batch``, ``SalmonnEngine.
generate_tokens`` and ``decode_rows``, greedy. The model, its prompts, its
work and its reference are the cell's family's (``benchlib/spec.py``).

Set-up draws the weights, lets the port quantize them where the
configuration says so, builds the model and runs one warm-up batch of the
cell's shapes, drawn apart from the timed ones. The window runs whole batches until ``seconds`` have passed. Then
the program is freed and the reference judges a sample of the served
requests, drawn from the seed with the longest prompt in it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from benchlib import port, roofline, traffic as gen_traffic, trace as tr, weights
from reference import check, model as ref_model
from reference.text import Tokenizer

EOS = 2


def build(cell, seed: int, device):
    """The port's model for the cell, its weights drawn from ``seed``."""
    cfg = cell.config
    dt = weights.DTYPES[cfg["torch_dtype"]]
    params = weights.make(cell.family.leaf_plan(cfg), seed, device, dt, dt)
    return cell.family.eval_model(cfg, cell.traffic, params, device)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        control: Optional[ref_model.Precision] = None) -> Dict:
    """One run of the cell → {"record", "correct", "attempted", "failed",
    "checks"}; with ``control`` also "control_checks", the control's
    reading of the same number (limits: ``calibrate.py``)."""
    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.data.collate import collate_icl_batch

    cuda = torch.device(device).type == "cuda"
    spec, cfg = cell.traffic, cell.config
    traffic = gen_traffic.generate(spec, seed)
    model = build(cell, seed, device)
    engine = model.engine
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def one(batch):
        with tr.span("collate"):
            packed = collate_icl_batch(cell.family.samples(traffic, batch), engine.tokenizer,
                                       model.pack_cfg)
        with tr.span("generate"):
            toks = engine.generate_tokens(packed, packed.audio)
        with tr.span("decode_rows"):
            engine.decode_rows(toks)
        return toks

    one(traffic.warmup())  # the cell's shapes, kernels built; drawn apart, never timed
    if cuda:
        torch.cuda.synchronize()
    engine.timings.clear()
    kernels.reset_launch_counts()
    syncs = [0]
    prof = tr.profiler() if trace else contextlib.nullcontext()
    done = []
    setup_s = time.perf_counter() - t0
    with prof:
        with (tr.count_syncs(syncs) if trace and cuda else contextlib.nullcontext()), \
                tr.span(tr.WINDOW):
            w0 = time.perf_counter()
            while True:
                with tr.span("batch"):
                    done.append(one(traffic.batch(len(done))))
                if time.perf_counter() - w0 >= seconds:
                    break
            window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    launches = kernels.launch_counts()
    timings = [list(t) for t in engine.timings]
    summary = tr.summarize(prof) if trace else None
    del model, engine
    port.free(device)

    tok = Tokenizer()
    work = roofline.Work()
    served, lengths = [], []
    for i, toks in enumerate(done):
        batch = traffic.batch(i)
        prompts = []
        for r, req in enumerate(batch):
            positions, text = cell.reference.prompt_length(spec["task"], req, tok)
            if positions > spec["seq_len"] or text > spec["text_len"]:
                raise RuntimeError(f"request {req.key} needs {positions} positions and {text} "
                                   f"text tokens: over the traffic's budget")
            prompts.append(positions)
            served.append((req, toks[r]))
            lengths.append(positions)
        clips = [c[1] for req in batch
                 for c in [e.clip for e in req.examples if e.clip] + [req.main_clip]]
        cell.family.eval_work(cfg, work, clips, prompts, spec["max_new_tokens"])

    rng = np.random.Generator(np.random.PCG64([seed, 1]))
    longest = int(np.argmax(lengths))
    others = [j for j in range(len(served)) if j != longest]
    n = min(spec["reference_requests"], len(served)) - 1
    picked = [longest] + sorted(rng.choice(others, n, replace=False).tolist())
    ref_model.full_precision()
    dt = weights.DTYPES[cfg["torch_dtype"]]
    tree = weights.make(cell.family.leaf_plan(cfg), seed, device, dt, dt)
    results = check.served_gaps(cell.reference.Plain(cfg, tree), spec["task"],
                                [served[j] for j in picked], traffic.wav, device, EOS,
                                ref_model.stated(cfg), control)
    limit = cell.limits.get("max_logit_gap")
    worst = [max(r["gaps"]) for r in results]
    value = max(worst)
    failed = sum(1 for g in worst if limit is None or g > limit)
    utterances = sum(len(t) for t in done)
    record = {
        "loop": "eval", "setup_s": setup_s, "window_s": window_s, "utterances": utterances,
        "batches": len(done), "peak_bytes": peak, "step_ms": timings, "syncs": syncs[0],
        "launches": launches, "work": work.as_dict(), "model_flops": work.model_flops,
        "opmap": cell.opmap, "trace": summary,
    }
    out = {"record": record, "correct": limit is not None and failed == 0,
           "attempted": utterances, "failed": failed,
           "checks": {"max_logit_gap": {"value": value, "limit": limit}}}
    if control is not None:
        out["control_checks"] = {"max_logit_gap": max(max(r["control_gaps"]) for r in results)}
    return out
