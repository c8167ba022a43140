"""The work a batch or a step asks of the card, from its inputs: each
operation's flops and bytes for the roofline shares, and the model flops
for the shares of the peak (``mfu``).

Model flops count the work the model needs and no more. Here, the
decoder's, which every family's counts (``benchlib/families/<family>.py``,
with the work of its audio side) share: the real prompt positions (not
padding), the decode steps, the LoRA products. Training adds the
backward's activation gradients, the LoRA weight gradients and the
attention backward; recomputation is not counted.

``n``, the decoder's sizes: D (hidden), L (layers), H and Hkv (query and KV
heads), hd (head size), F (FFN) and V (vocabulary). ``cfg``, the
configuration file, gives its ``lora`` and ``quant``.
"""

from __future__ import annotations

from typing import Dict, Sequence

from . import roofline as R


def _linear_params(n: Dict) -> int:
    """Weight elements of one decoder layer's seven products."""
    D, q, kv, F = n["D"], n["H"] * n["hd"], n["Hkv"] * n["hd"], n["F"]
    return D * q + 2 * D * kv + q * D + 3 * D * F


def _lora_params(cfg: Dict, n: Dict) -> int:
    lora = cfg.get("lora")
    if not lora:
        return 0
    outs = {"wq": n["H"] * n["hd"], "wk": n["Hkv"] * n["hd"], "wv": n["Hkv"] * n["hd"]}
    return sum(lora["rank"] * (n["D"] + outs[t]) for t in lora["targets"])


def _products(n: Dict):
    D, q, kv, F = n["D"], n["H"] * n["hd"], n["Hkv"] * n["hd"], n["F"]
    return [(D, q), (D, kv), (D, kv), (q, D), (D, F), (D, F), (F, D)]


def decoder_prefill(cfg: Dict, n: Dict, work: R.Work, prompts: Sequence[int]) -> None:
    """The causal prefill of prompts of these lengths, logits at the last."""
    per_pos = 2.0 * n["L"] * (_linear_params(n) + _lora_params(cfg, n))
    for P in prompts:
        fl, by = R.attention_fwd(n["H"], n["Hkv"], n["hd"], P, R.causal_pairs(P), P)
        work.model_flops += P * per_pos + n["L"] * fl + 2.0 * n["D"] * n["V"]
        work.add("prefill_attention", n["L"] * fl, n["L"] * by)


def decode(cfg: Dict, n: Dict, work: R.Work, prompts: Sequence[int], new_tokens: int) -> None:
    """``new_tokens`` tokens for every row: the first from the prefill's
    logits, then ``new_tokens - 1`` cached steps over the whole batch."""
    quant = cfg.get("quant")
    per_row = 2.0 * n["L"] * (_linear_params(n) + _lora_params(cfg, n)) + 2.0 * n["D"] * n["V"]
    attn = R.decode_attention_q8 if quant and quant.get("kv_int8") else R.decode_attention_bf16
    m = len(prompts)
    for t in range(1, new_tokens):
        for P in prompts:
            fl, by = attn(n["H"], n["Hkv"], n["hd"], P + t - 1)
            work.model_flops += per_row + n["L"] * fl
            work.add("decode_attention", n["L"] * fl, n["L"] * by)
    if quant:
        for t in range(new_tokens):
            if t:
                for k, out in _products(n):
                    fl, by = R.qmatmul(m, k, out, quant["weight_bits"], quant["group"])
                    work.add("qmatmul", n["L"] * fl, n["L"] * by)
            if quant["lm_head_bits"]:
                fl, by = R.qmatmul(m, n["D"], n["V"], quant["lm_head_bits"])
                work.add("qmatmul", fl, by)


def train_step(cfg: Dict, n: Dict, work: R.Work, positions: Sequence[int]) -> None:
    """The decoder's forward and backward over sequences of these real
    lengths (prompt and completion), with the frozen weights' activation
    gradients, the LoRA weight gradients and the lm_head at every real
    position."""
    lin, lora = _linear_params(n), _lora_params(cfg, n)
    for P in positions:
        fl, by = R.attention_fwd(n["H"], n["Hkv"], n["hd"], P, R.causal_pairs(P), P)
        bfl, bby = R.attention_bwd(n["H"], n["Hkv"], n["hd"], P, R.causal_pairs(P), P)
        work.add("train_attention_fwd", n["L"] * fl, n["L"] * by)
        work.add("train_attention_bwd", n["L"] * bfl, n["L"] * bby)
        work.model_flops += (2.0 * P * n["L"] * lin * 2  # forward, activation gradients
                             + 2.0 * P * n["L"] * lora * 3  # forward, dX, dW
                             + n["L"] * (fl + bfl)
                             + 2.0 * P * n["D"] * n["V"] * 2)
