"""Decoder-only transformer (LLaMA/Vicuna, Qwen2 config space) in PyTorch.

Counterpart of ``icl_speech_text_llm_tpu/models/llama.py`` for the static
engine's inference path: stacked ``(L, ...)`` layer weights walked by a
Python loop, grouped-query attention with RoPE, LoRA added inside the q/v
projections, and a KV cache updated in place.

- ``decoder_forward`` is the causal prefill: attention goes through the
  causal flash op with per-sample lengths (GQA without a repeated copy),
  and each layer's k/v land in the cache as they are computed.
- ``decode_step`` is the single-token cached step of the JAX package's
  ``_decode_step_zero_copy(attn_mode="xla")``: each layer attends its cache
  slice ``cache_k[l]`` read-only with the current token folded in as one
  extra column, and ONE ``append_kv`` writes every layer's new k/v after the
  loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.flash_attention import append_kv, flash_attention
from .common import (
    apply_rope,
    dense_init,
    layer_at,
    normal_init,
    rms_norm,
    rope_frequencies,
)


@dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    hidden_dim: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    qkv_bias: bool = False
    tie_embeddings: bool = False
    max_seq_len: int = 4096

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.dim // self.n_heads


DECODER_CONFIGS: Dict[str, DecoderConfig] = {
    "vicuna-13b": DecoderConfig(vocab_size=32000, dim=5120, n_layers=40, n_heads=40,
                                n_kv_heads=40, hidden_dim=13824),
    "vicuna-7b": DecoderConfig(vocab_size=32000, dim=4096, n_layers=32, n_heads=32,
                               n_kv_heads=32, hidden_dim=11008),
    "qwen2-7b": DecoderConfig(vocab_size=156032, dim=3584, n_layers=28, n_heads=28,
                              n_kv_heads=4, hidden_dim=18944, qkv_bias=True,
                              rope_theta=1_000_000.0),
    "qwen2-0.5b": DecoderConfig(vocab_size=151936, dim=896, n_layers=24, n_heads=14,
                                n_kv_heads=2, hidden_dim=4864, qkv_bias=True,
                                rope_theta=1_000_000.0, tie_embeddings=True),
    "tiny": DecoderConfig(vocab_size=36764, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                          hidden_dim=352, max_seq_len=2048),
    "bench": DecoderConfig(vocab_size=36764, dim=1024, n_layers=8, n_heads=8, n_kv_heads=4,
                           hidden_dim=2816, max_seq_len=2048),
}


def init_decoder(cfg: DecoderConfig, gen: torch.Generator, device, dtype) -> Dict[str, Any]:
    """Random-init decoder params; per-layer leaves stacked along axis 0."""
    L, hd = cfg.n_layers, cfg.hd

    def dense(i, o, lead=(L,)):
        return dense_init(gen, i, o, device, dtype, lead)

    layers = {
        "attn": {"wq": dense(cfg.dim, cfg.n_heads * hd),
                 "wk": dense(cfg.dim, cfg.n_kv_heads * hd),
                 "wv": dense(cfg.dim, cfg.n_kv_heads * hd),
                 "wo": dense(cfg.n_heads * hd, cfg.dim)},
        "mlp": {"w_gate": dense(cfg.dim, cfg.hidden_dim),
                "w_up": dense(cfg.dim, cfg.hidden_dim),
                "w_down": dense(cfg.hidden_dim, cfg.dim)},
        "ln_attn": torch.ones((L, cfg.dim), device=device, dtype=dtype),
        "ln_mlp": torch.ones((L, cfg.dim), device=device, dtype=dtype),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads * hd), ("bk", cfg.n_kv_heads * hd),
                            ("bv", cfg.n_kv_heads * hd)):
            layers["attn"][name] = torch.zeros((L, width), device=device, dtype=dtype)
    params = {
        "tok_embed": normal_init(gen, (cfg.vocab_size, cfg.dim), 0.02, device, dtype),
        "layers": layers,
        "final_norm": torch.ones((cfg.dim,), device=device, dtype=dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(cfg.dim, cfg.vocab_size, ())
    return params


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------

LORA_TARGET_SHAPES = {
    "wq": ("dim", "q_out"), "wk": ("dim", "kv_out"), "wv": ("dim", "kv_out"),
    "wo": ("q_out", "dim"), "w_gate": ("dim", "hidden"), "w_up": ("dim", "hidden"),
    "w_down": ("hidden", "dim"),
}


@dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    dropout: float = 0.05
    targets: Tuple[str, ...] = ("wq", "wv")

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _target_dims(cfg: DecoderConfig, name: str) -> Tuple[int, int]:
    dims = {"dim": cfg.dim, "q_out": cfg.n_heads * cfg.hd,
            "kv_out": cfg.n_kv_heads * cfg.hd, "hidden": cfg.hidden_dim}
    d_in, d_out = LORA_TARGET_SHAPES[name]
    return dims[d_in], dims[d_out]


def init_lora(cfg: DecoderConfig, lora_cfg: LoraConfig, gen: torch.Generator,
              device, dtype) -> Dict[str, Any]:
    """Per target: stacked (L, d_in, r) A ~ N(0, 1/d_in) and (L, r, d_out) B = 0
    (the adapter starts as the identity, PEFT convention)."""
    tree = {}
    for name in lora_cfg.targets:
        d_in, d_out = _target_dims(cfg, name)
        tree[name] = {
            "a": normal_init(gen, (cfg.n_layers, d_in, lora_cfg.rank), d_in ** -0.5,
                             device, dtype),
            "b": torch.zeros((cfg.n_layers, lora_cfg.rank, d_out), device=device, dtype=dtype),
        }
    return tree


def _proj(x, w, lora_layer, name: str, scaling: float, bias=None):
    """x @ w (+ bias) with the optional additive LoRA delta ((x·A)·B)·scaling."""
    y = torch.matmul(x, w.to(x.dtype))
    if lora_layer is not None and name in lora_layer:
        a = lora_layer[name]["a"].to(x.dtype)
        b = lora_layer[name]["b"].to(x.dtype)
        y = y + torch.matmul(torch.matmul(x, a), b) * scaling
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _qkv_heads(cfg, layer, lora_layer, lora_scaling, x, positions, inv_freq):
    """Pre-norm, q/k/v projections, head split and RoPE → (B, H|Hkv, T, hd)."""
    B, T, _ = x.shape
    hd = cfg.hd
    attn = layer["attn"]
    h = rms_norm(x, layer["ln_attn"], cfg.rms_eps)
    q = _proj(h, attn["wq"], lora_layer, "wq", lora_scaling, attn.get("bq"))
    k = _proj(h, attn["wk"], lora_layer, "wk", lora_scaling, attn.get("bk"))
    v = _proj(h, attn["wv"], lora_layer, "wv", lora_scaling, attn.get("bv"))
    q = q.view(B, T, cfg.n_heads, hd).transpose(1, 2)
    k = k.view(B, T, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.view(B, T, cfg.n_kv_heads, hd).transpose(1, 2)
    return apply_rope(q, positions, inv_freq), apply_rope(k, positions, inv_freq), v


def _attn_out_mlp(cfg, layer, lora_layer, lora_scaling, x, out):
    """Attention output projection + residual + SwiGLU MLP block."""
    attn, mlp = layer["attn"], layer["mlp"]
    x = x + _proj(out, attn["wo"], lora_layer, "wo", lora_scaling)
    h = rms_norm(x, layer["ln_mlp"], cfg.rms_eps)
    gate = _proj(h, mlp["w_gate"], lora_layer, "w_gate", lora_scaling)
    up = _proj(h, mlp["w_up"], lora_layer, "w_up", lora_scaling)
    return x + _proj(F.silu(gate) * up, mlp["w_down"], lora_layer, "w_down", lora_scaling)


def _inv_freq(cfg: DecoderConfig, device) -> torch.Tensor:
    return torch.from_numpy(rope_frequencies(cfg.hd, cfg.rope_theta)).to(device)


def init_kv_cache(cfg: DecoderConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device=None) -> Dict[str, torch.Tensor]:
    """Stacked KV cache {"k", "v"}: (L, B, Hkv, max_len, hd)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decoder_forward(cfg: DecoderConfig, params: Dict[str, Any], inputs_embeds: torch.Tensor,
                    lengths: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]] = None,
                    lora: Optional[Dict[str, Any]] = None, lora_scaling: float = 1.0,
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Causal prefill over right-padded prompts: inputs_embeds (B, T, dim),
    lengths (B,) valid positions. Writes every layer's k/v into cache[..., :T, :]
    in place when a cache is given. Returns (final-normed hidden, cache)."""
    B, T, _ = inputs_embeds.shape
    inv_freq = _inv_freq(cfg, inputs_embeds.device)
    positions = torch.arange(T, device=inputs_embeds.device)[None].expand(B, T)
    x = inputs_embeds
    for l in range(cfg.n_layers):
        layer = layer_at(params["layers"], l)
        lo = layer_at(lora, l) if lora is not None else None
        q, k, v = _qkv_heads(cfg, layer, lo, lora_scaling, x, positions, inv_freq)
        if cache is not None:
            cache["k"][l, :, :, :T] = k
            cache["v"][l, :, :, :T] = v
        out = flash_attention(q, k.to(q.dtype), v.to(q.dtype), lengths, causal=True)
        out = out.transpose(1, 2).reshape(B, T, cfg.n_heads * cfg.hd)
        x = _attn_out_mlp(cfg, layer, lo, lora_scaling, x, out)
    return rms_norm(x, params["final_norm"], cfg.rms_eps), cache


def _xla_decode_attn(cfg: DecoderConfig, q, ck, cv, k_self, v_self, lengths):
    """Single-token decode attention over one layer's cache slice.

    q (B, H, 1, hd); ck/cv (B, Hkv, S, hd), read-only; the current token's
    (k_self, v_self) (B, Hkv, 1, hd) is one extra softmax column; cache
    positions ≥ lengths[b] are masked. GQA by grouped matmuls, no repeat."""
    B, H, _, hd = q.shape
    Hkv, S = ck.shape[1], ck.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, hd).float()
    sm = hd ** -0.5
    s_cache = torch.matmul(qg, ck.float().transpose(-1, -2)) * sm  # (B, Hkv, g, S)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s_cache = s_cache.masked_fill(~valid[:, None, None, :], float("-inf"))
    s_self = torch.matmul(qg, k_self.reshape(B, Hkv, hd, 1).float()) * sm  # (B, Hkv, g, 1)
    m = torch.maximum(s_cache.amax(dim=-1, keepdim=True), s_self)
    p_cache = torch.exp(s_cache - m)
    p_self = torch.exp(s_self - m)
    l = p_cache.sum(dim=-1, keepdim=True) + p_self
    out = torch.matmul(p_cache.to(q.dtype), cv.to(q.dtype)).float()
    out = out + p_self * v_self.reshape(B, Hkv, 1, hd).float()
    return (out / l).reshape(B, H, 1, hd).to(q.dtype)


def decode_step(cfg: DecoderConfig, params: Dict[str, Any], x: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_positions: torch.Tensor,
                lora: Optional[Dict[str, Any]] = None, lora_scaling: float = 1.0,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One cached decode step: x (B, 1, dim) at positions cache_positions (B,)
    (each sample's count of cached tokens). Every layer attends its cache
    slice read-only plus the current token; after the loop ONE append_kv
    writes all layers' new k/v at cache_positions, in place."""
    B = x.shape[0]
    L, hd = cfg.n_layers, cfg.hd
    inv_freq = _inv_freq(cfg, x.device)
    positions = cache_positions[:, None]
    new_k = torch.empty((L, B, cfg.n_kv_heads, 1, hd), dtype=cache["k"].dtype, device=x.device)
    new_v = torch.empty_like(new_k)
    for l in range(L):
        layer = layer_at(params["layers"], l)
        lo = layer_at(lora, l) if lora is not None else None
        q, k, v = _qkv_heads(cfg, layer, lo, lora_scaling, x, positions, inv_freq)
        out = _xla_decode_attn(cfg, q, cache["k"][l], cache["v"][l], k, v, cache_positions)
        new_k[l] = k
        new_v[l] = v
        x = _attn_out_mlp(cfg, layer, lo, lora_scaling, x,
                          out.transpose(1, 2).reshape(B, 1, cfg.n_heads * hd))
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    append_kv(cache["k"], cache["v"], new_k, new_v, cache_positions)
    return x, cache


def embed_tokens(params: Dict[str, Any], token_ids: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Token ids → embeddings. Ids past the table clamp to its last row, as
    the JAX package's gather does (the in-repo tokenizer's vocabulary is
    larger than Vicuna's 32000)."""
    table = params["tok_embed"]
    return table[token_ids.clamp(max=table.shape[0] - 1)].to(dtype)


def lm_logits(cfg: DecoderConfig, params: Dict[str, Any], hidden: torch.Tensor) -> torch.Tensor:
    w = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(hidden, w.to(hidden.dtype))
