"""The reference's side of ``correct``, the same for every family: the
plain model over each prompt built again from its raw fields, and the
numbers that the program's outputs are judged by.

The drivers hand these functions the plain model of the cell's family
(``reference/families/<family>.py:Plain``): an object with ``prompt_embeds(task, request,
wav, tok, device, precision)`` → (P, D) float32 embeddings of a request's
prompt, ``embed(ids, device)``, ``decoder(x, lora, precision,
cached_from=None, checkpointed=False)``, ``logits(hidden, precision)``
and ``lora``, the tree's LoRA leaves ({target: {"a", "b"}}) or None.

Served tokens: the reference runs once over a prompt and the tokens the
program served after it, and reads, at each served token up to the first
EOS, by how much that token's logit lies below the reference's best. A
control in a lower precision reads the same gap for the token it would
put first.

Training: the reference takes the program's first steps again in float32,
from the same weights and batches, with its own AdamW.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import model as M
from .text import Tokenizer


def _gaps(ref: torch.Tensor, picks: torch.Tensor) -> List[float]:
    best = ref.max(dim=-1).values
    got = ref.gather(1, picks[:, None].long())[:, 0]
    return (best - got).tolist()


@torch.no_grad()
def served_gaps(model, task: Dict, served: Sequence[Tuple[object, np.ndarray]],
                wav: Callable, device, eos: int, precision: M.Precision = M.Precision(),
                control: Optional[M.Precision] = None) -> List[Dict]:
    """For each (request, served tokens): ``gaps``, the reference's best
    logit less that of each served token up to and including the first
    EOS; with ``control``, ``control_gaps``, the same for the token the
    control puts first at each of those positions (fed the served tokens)."""
    tok = Tokenizer()
    quant_kv = precision.kv_bits is not None or (control is not None and control.kv_bits)
    out = []
    for request, tokens in served:
        tokens = [int(t) for t in tokens]
        n = next((i + 1 for i, t in enumerate(tokens) if t == eos), len(tokens))
        rows = {}
        for name, prec in (("gaps", precision), ("control_gaps", control)):
            if prec is None:
                continue
            prompt = model.prompt_embeds(task, request, wav, tok, device, prec)
            P = prompt.shape[0]
            x = torch.cat([prompt, model.embed(tokens[:n - 1], device)]) if n > 1 else prompt
            hidden = model.decoder(x, model.lora, prec, cached_from=P if quant_kv else None)
            rows[name] = model.logits(hidden[P - 1:P - 1 + n], prec)
        ref = rows["gaps"]
        item = {"gaps": _gaps(ref, torch.tensor(tokens[:n], device=device)), "tokens": n}
        if control is not None:
            item["control_gaps"] = _gaps(ref, rows["control_gaps"].argmax(dim=-1))
        out.append(item)
    return out


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------


def _lora_leaves(lora: Dict) -> List[Tuple[str, torch.Tensor]]:
    return [(f"{t}.{k}", lora[t][k]) for t in lora for k in ("a", "b")]


def train_steps(model, task: Dict, batches: Sequence[Sequence[object]],
                wav: Callable, device, opt: Dict,
                precision: M.Precision = M.Precision()) -> Dict:
    """The program's first ``len(batches)`` steps in float32: the token-mean
    cross entropy over each batch's completions, the gradient of the LoRA
    leaves, clipping by their global norm, then AdamW (bias-corrected
    moments, eps outside the root, decoupled decay). → {"losses",
    "grads" (step 1's clipped gradient per leaf), "start", "end" (the LoRA
    before and after)}."""
    tok = Tokenizer()
    lora = {t: {k: v.detach().float().clone().requires_grad_(True) for k, v in d.items()}
            for t, d in model.lora.items()}
    named = _lora_leaves(lora)
    start = {name: p.detach().clone() for name, p in named}
    mu = {name: torch.zeros_like(p) for name, p in named}
    nu = {name: torch.zeros_like(p) for name, p in named}
    losses, first = [], None
    for step, batch in enumerate(batches, start=1):
        prepared = []
        with torch.no_grad():
            for request in batch:
                completion = tok.encode(request.label)
                prompt = model.prompt_embeds(task, request, wav, tok, device, precision)
                prepared.append((prompt, completion))
        count = sum(len(c) for _, c in prepared)
        total = 0.0
        for prompt, completion in prepared:
            P = prompt.shape[0]
            x = torch.cat([prompt, model.embed(completion, device)])
            hidden = model.decoder(x, lora, precision, checkpointed=True)
            lg = model.logits(hidden[P - 1:P - 1 + len(completion)], precision)
            nll = torch.nn.functional.cross_entropy(
                lg, torch.tensor(completion, device=device), reduction="sum")
            (nll / count).backward()
            total += float(nll.detach()) / count
        losses.append(total)
        with torch.no_grad():
            grads = {name: p.grad.detach().clone() for name, p in named}
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            if not bool(norm < opt["max_grad_norm"]):
                grads = {k: g / norm * opt["max_grad_norm"] for k, g in grads.items()}
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            b1, b2 = opt["b1"], opt["b2"]
            bc1 = 1.0 - float(np.float32(b1) ** np.float32(step))
            bc2 = 1.0 - float(np.float32(b2) ** np.float32(step))
            for name, p in named:
                g = grads[name]
                mu[name].mul_(b1).add_(g, alpha=1.0 - b1)
                nu[name].mul_(b2).add_(g * g, alpha=1.0 - b2)
                u = (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2) + 1e-8)
                p.add_(u + opt["weight_decay"] * p, alpha=-opt["learning_rate"])
                p.grad = None
    return {"losses": losses, "grads": first, "start": start,
            "end": {name: p.detach().clone() for name, p in named}}
