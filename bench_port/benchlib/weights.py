"""Random weights for a configuration file, drawn from the seed on the
device, one call a leaf, in the type they are served in.

The tree has the shapes and key names that the port's Qwen2-Audio takes
(stacked ``(L, ...)`` layer leaves, matmul weights stored ``(in, out)``),
and the reference reads the same tree. Matmul weights are N(0, 1/in);
embeddings N(0, 0.02²); biases N(0, 0.02²); norms 1; LoRA A N(0, 1/in) and
B N(0, 0.01²), so the adapter is not the identity.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def dims(cfg: Dict) -> Dict[str, int]:
    a, t = cfg["audio_config"], cfg["text_config"]
    hd = t["hidden_size"] // t["num_attention_heads"]
    return {
        "mels": a["num_mel_bins"], "d": a["d_model"], "enc_layers": a["encoder_layers"],
        "enc_heads": a["encoder_attention_heads"], "enc_ffn": a["encoder_ffn_dim"],
        "frames": a["max_source_positions"],
        "D": t["hidden_size"], "L": t["num_hidden_layers"], "H": t["num_attention_heads"],
        "Hkv": t["num_key_value_heads"], "hd": hd, "F": t["intermediate_size"],
        "V": t["vocab_size"], "pool": cfg["audio_pool_stride"],
    }


def sinusoids(length: int, dim: int) -> np.ndarray:
    """Whisper's position table: sin then cos over geometric timescales."""
    inv = np.exp(-np.log(10000.0) / (dim // 2 - 1) * np.arange(dim // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def leaf_plan(cfg: Dict):
    """[(path, shape, init)] in drawing order; init is ("normal", std),
    ("ones",) or ("sinusoids",)."""
    n = dims(cfg)
    d, L, Le, D = n["d"], n["L"], n["enc_layers"], n["D"]
    q_out, kv_out = n["H"] * n["hd"], n["Hkv"] * n["hd"]

    def w(i, o, lead=()):
        return (lead + (i, o), ("normal", i ** -0.5))

    def bias(*shape):
        return (shape, ("normal", 0.02))

    def ones(*shape):
        return (shape, ("ones",))

    plan = [
        (("encoder", "conv1", "w"), (3, n["mels"], d), ("normal", (3 * n["mels"]) ** -0.5)),
        (("encoder", "conv1", "b"),) + bias(d),
        (("encoder", "conv2", "w"), (3, d, d), ("normal", (3 * d) ** -0.5)),
        (("encoder", "conv2", "b"),) + bias(d),
        (("encoder", "positions"), (n["frames"], d), ("sinusoids",)),
    ]
    blk = ("encoder", "blocks")
    for name, spec in (
        (("ln1", "w"), ones(Le, d)), (("ln1", "b"), bias(Le, d)),
        (("attn", "wq"), w(d, d, (Le,))), (("attn", "bq"), bias(Le, d)),
        (("attn", "wk"), w(d, d, (Le,))),
        (("attn", "wv"), w(d, d, (Le,))), (("attn", "bv"), bias(Le, d)),
        (("attn", "wo"), w(d, d, (Le,))), (("attn", "bo"), bias(Le, d)),
        (("ln2", "w"), ones(Le, d)), (("ln2", "b"), bias(Le, d)),
        (("mlp", "w1"), w(d, n["enc_ffn"], (Le,))), (("mlp", "b1"), bias(Le, n["enc_ffn"])),
        (("mlp", "w2"), w(n["enc_ffn"], d, (Le,))), (("mlp", "b2"), bias(Le, d)),
    ):
        plan.append((blk + name,) + spec)
    plan += [
        (("encoder", "ln_post", "w"),) + ones(d),
        (("encoder", "ln_post", "b"),) + bias(d),
        (("projector", "w"),) + w(d, D),
        (("projector", "b"),) + bias(D),
    ]
    lora = cfg.get("lora")
    if lora:
        r = lora["rank"]
        outs = {"wq": q_out, "wk": kv_out, "wv": kv_out}
        for tgt in lora["targets"]:
            plan.append((("lora", tgt, "a"), (L, D, r), ("normal", D ** -0.5)))
            plan.append((("lora", tgt, "b"), (L, r, outs[tgt]), ("normal", 0.01)))
    lay = ("llm", "layers")
    plan.append((("llm", "tok_embed"), (n["V"], D), ("normal", 0.02)))
    for name, spec in (
        (("attn", "wq"), w(D, q_out, (L,))), (("attn", "wk"), w(D, kv_out, (L,))),
        (("attn", "wv"), w(D, kv_out, (L,))), (("attn", "wo"), w(q_out, D, (L,))),
        (("attn", "bq"), bias(L, q_out)), (("attn", "bk"), bias(L, kv_out)),
        (("attn", "bv"), bias(L, kv_out)),
        (("mlp", "w_gate"), w(D, n["F"], (L,))), (("mlp", "w_up"), w(D, n["F"], (L,))),
        (("mlp", "w_down"), w(n["F"], D, (L,))),
        (("ln_attn",), ones(L, D)), (("ln_mlp",), ones(L, D)),
    ):
        if name[0] == "attn" and name[1].startswith("b") and not cfg["text_config"]["qkv_bias"]:
            continue
        plan.append((lay + name,) + spec)
    plan.append((("llm", "final_norm"),) + ones(D))
    plan.append((("llm", "lm_head"),) + w(D, n["V"]))
    return plan


def make(cfg: Dict, seed: int, device, dtype=torch.bfloat16,
         lora_dtype=torch.float32) -> Dict[str, Any]:
    """The weight tree of ``cfg`` from ``seed``: ``dtype`` leaves, the LoRA
    in ``lora_dtype``; the same seed on the same device gives the same
    tree."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: Dict[str, Any] = {}
    for path, shape, init in leaf_plan(cfg):
        dt = lora_dtype if path[0] == "lora" else dtype
        if init[0] == "normal":
            leaf = torch.empty(shape, dtype=dt, device=device).normal_(0.0, init[1],
                                                                     generator=gen)
        elif init[0] == "ones":
            leaf = torch.ones(shape, dtype=dt, device=device)
        else:
            leaf = torch.from_numpy(sinusoids(*shape)).to(device=device, dtype=dt)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree

