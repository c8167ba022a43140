"""The LoRA fine-tune loop: ``make_train_step`` steps back to back (a closed
loop), each on a batch built by the port's prompt builder and
``collate_icl_batch``, AdamW over the float32 LoRA.

Set-up builds the one training step with its model and optimizer state
and drives it through its first ``setup_steps`` steps, the warm-up; the
same objects then step through the window. The reference follows the
first ``reference_steps`` steps, so the window's own first steps among
them: the harness keeps each of those steps' loss, the first gradient as
the optimizer got it (from its first moment after one step) and the LoRA
before the first step and after the last (a copy taken inside the
window). Once the program is freed, the reference takes those steps again
in float32.

The numbers compared, each by the worst layer slice of each LoRA leaf:
``loss_gap`` the largest relative gap of a step's loss; ``grad_gap`` the
gap between the program's and the reference's norm of a slice's first
gradient; ``update_gap`` the same for its change over the steps; both over
the larger of the reference's norm of that slice and of the median slice.
Slices whose reference gradient is under a thousandth of the median
slice's are left out.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from benchlib import port, roofline, traffic as gen_traffic, trace as tr, weights
from reference import check, model as ref_model
from reference.text import Tokenizer


def _slices(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-layer slices of stacked leaves, as float32 on the host."""
    return {f"{name}[{l}]": t[l].detach().float().cpu() for name, t in tree.items()
            for l in range(t.shape[0])}


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers from both sides' {"losses", "grads", "start",
    "end"} (leaves keyed alike)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    gp, gr = _slices(prog["grads"]), _slices(ref["grads"])
    norm = {k: float(v.norm()) for k, v in gr.items()}
    med = float(np.median(list(norm.values())))
    kept = [k for k, v in norm.items() if v >= 1e-3 * med]
    grad = max(abs(float(gp[k].norm()) - norm[k]) / max(norm[k], med) for k in kept)
    dp = {k: v - s for (k, v), s in zip(_slices(prog["end"]).items(),
                                         _slices(prog["start"]).values())}
    dr = {k: v - s for (k, v), s in zip(_slices(ref["end"]).items(),
                                         _slices(ref["start"]).values())}
    dnorm = {k: float(dr[k].norm()) for k in kept}
    dmed = float(np.median(list(dnorm.values())))
    update = max(abs(float(dp[k].norm()) - dnorm[k]) / max(dnorm[k], dmed) for k in kept)
    return {"loss_gap": loss, "grad_gap": grad, "update_gap": update}


def _leaves(lora) -> Dict[str, torch.Tensor]:
    return {f"{t}.{k}": lora[t][k] for t in lora for k in ("a", "b")}


def _lora(state) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in _leaves(state.trainable["lora"]).items()}


def _first_gradient(state, b1: float) -> Dict[str, torch.Tensor]:
    """Step 1's gradient as the optimizer got it: AdamW's first moment after
    one step, over (1 - b1)."""
    try:
        mu = state.opt_state["mu"]["lora"]
    except (KeyError, TypeError) as e:
        raise RuntimeError("the train step's optimizer state holds no first moment "
                           "opt_state['mu']['lora']: the first gradient cannot be read") from e
    return {k: v / (1.0 - b1) for k, v in _leaves(mu).items()}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        control: ref_model.Precision = None) -> Dict:
    """One run of the cell → {"record", "correct", "attempted", "failed",
    "checks"}; with ``control`` also "control_checks": the reference in
    that precision, put in the program's place (limits: ``calibrate.py``)."""
    from icl_speech_text_llm_tpu_torch import kernels
    from icl_speech_text_llm_tpu_torch.data.collate import collate_icl_batch
    from icl_speech_text_llm_tpu_torch.training.step import (
        AdamW,
        OptimizerSettings,
        init_train_state,
        make_train_step,
    )
    from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

    cuda = torch.device(device).type == "cuda"
    spec, cfg, family, ref = cell.traffic, cell.config, cell.family, cell.reference
    traffic = gen_traffic.generate(spec, seed)
    pc = family.port_config(cfg)
    dt = weights.DTYPES[cfg["torch_dtype"]]
    o = spec["optimizer"]
    optimizer = AdamW(OptimizerSettings(learning_rate=o["learning_rate"],
                                        weight_decay=o["weight_decay"],
                                        max_grad_norm=o["max_grad_norm"], b1=o["b1"], b2=o["b2"]))
    state, frozen = init_train_state(weights.make(family.leaf_plan(cfg), seed, device, dt),
                                     optimizer, trainable_keys=("lora",))
    step = make_train_step(pc, optimizer, loss_fn=family.train_loss(), remat=spec["remat"])
    tok = get_tokenizer()
    pack = family.pack_config(spec, pc)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    n_setup, n_ref = int(spec["setup_steps"]), int(spec["reference_steps"])
    if not 1 <= n_setup < n_ref:
        raise ValueError("the reference follows the window's first steps: "
                         "1 <= setup_steps < reference_steps")

    def one(i):
        with tr.span("collate"):
            b = collate_icl_batch(family.samples(traffic, traffic.batch(i)), tok, pack)
            arrays = {"text_tokens": b.text_tokens, "gather_idx": b.gather_idx,
                      "seq_mask": b.seq_mask, "shifted_labels": b.labels_shifted, **b.audio}
            batch = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in arrays.items()}
        with tr.span("step"):
            return step(state, frozen, batch)[1]

    prog = {"start": _lora(state), "losses": []}
    for i in range(n_setup):  # the warm-up: the first steps the reference follows
        prog["losses"].append(one(i)["loss"])
        if i == 0:
            prog["grads"] = _first_gradient(state, o["b1"])
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    syncs = [0]
    prof = tr.profiler() if trace else contextlib.nullcontext()
    metrics: List[Dict] = []
    setup_s = time.perf_counter() - t0
    with prof:
        with (tr.count_syncs(syncs) if trace and cuda else contextlib.nullcontext()), \
                tr.span(tr.WINDOW):
            w0 = time.perf_counter()
            while True:
                i = n_setup + len(metrics)
                with tr.span("batch"):
                    metrics.append(one(i))
                if i < n_ref:
                    prog["losses"].append(metrics[-1]["loss"])
                    if i + 1 == n_ref:
                        prog["end"] = _lora(state)
                if time.perf_counter() - w0 >= seconds and i + 1 >= n_ref:
                    break
            window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    launches = kernels.launch_counts()
    summary = tr.summarize(prof) if trace else None
    del state, frozen, step
    port.free(device)

    text_tok = Tokenizer()
    work = roofline.Work()
    for i in range(n_setup, n_setup + len(metrics)):
        batch = traffic.batch(i)
        positions = [ref.prompt_length(spec["task"], r, text_tok)[0]
                     + len(text_tok.encode(r.label)) for r in batch]
        if max(positions) > spec["seq_len"]:
            raise RuntimeError("a training example is over the traffic's budget")
        clips = [c[1] for r in batch
                 for c in [e.clip for e in r.examples if e.clip] + [r.main_clip]]
        family.train_work(cfg, work, clips, positions)

    ref_model.full_precision()
    plain = ref.Plain(cfg, weights.make(family.leaf_plan(cfg), seed, device, dt))
    first = [traffic.batch(i) for i in range(n_ref)]
    followed = check.train_steps(plain, spec["task"], first, traffic.wav, device, o,
                                 ref_model.stated(cfg))
    lower = None
    if control is not None:
        lower = gaps(check.train_steps(plain, spec["task"], first, traffic.wav, device, o,
                                       control), followed)
    del plain
    found = gaps(prog, followed)
    checks = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in found.items()}
    correct = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    steps = len(metrics)
    record = {
        "loop": "train", "setup_s": setup_s, "window_s": window_s, "steps": steps,
        "examples": steps * spec["batch_size"], "peak_bytes": peak, "syncs": syncs[0],
        "launches": launches, "work": work.as_dict(), "model_flops": work.model_flops,
        "opmap": cell.opmap, "trace": summary,
    }
    failed = sum(1 for m in metrics if m["skipped_nonfinite"])
    out = {"record": record, "correct": correct and failed == 0, "attempted": steps,
           "failed": failed, "checks": checks}
    if lower is not None:
        out["control_checks"] = lower
    return out
