"""Whisper audio encoder in PyTorch.

Counterpart of ``icl_speech_text_llm_tpu/models/whisper.py``: conv1(k3,s1)
→ gelu → conv2(k3,s2) → gelu → +sinusoid positions → N pre-LN blocks (MHA
with biases, GELU MLP) → final LN; (B, n_mels, 3000) mel in, (B, 1500, dim)
out. Self-attention goes through the non-causal flash op over the 1500 real
frames: the kernel masks the ragged last tile itself, so the 1500→1536
padding of the Pallas path is gone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention
from .common import (
    dense_init,
    full_f32,
    gelu,
    layer_at,
    layer_norm,
    linear,
    sinusoidal_positions,
)


@dataclass(frozen=True)
class WhisperEncoderConfig:
    n_mels: int = 80
    n_ctx: int = 1500  # frames after the stride-2 conv
    dim: int = 1280
    n_heads: int = 20
    n_layers: int = 32


WHISPER_CONFIGS: Dict[str, WhisperEncoderConfig] = {
    "large-v2": WhisperEncoderConfig(),
    "tiny-test": WhisperEncoderConfig(dim=64, n_heads=4, n_layers=2),
}


def init_whisper_encoder(cfg: WhisperEncoderConfig, gen: torch.Generator,
                         device, dtype) -> Dict[str, Any]:
    d, L = cfg.dim, cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    return {
        # conv kernels stored (width, in, out), as the JAX tree
        "conv1": {"w": dense_init(gen, 3 * cfg.n_mels, d, device, dtype).view(3, cfg.n_mels, d),
                  "b": zeros(d)},
        "conv2": {"w": dense_init(gen, 3 * d, d, device, dtype).view(3, d, d),
                  "b": zeros(d)},
        "positions": torch.from_numpy(sinusoidal_positions(cfg.n_ctx, d)).to(device, dtype),
        "blocks": {
            "ln1": {"w": ones(L, d), "b": zeros(L, d)},
            "attn": {
                "wq": dense_init(gen, d, d, device, dtype, (L,)), "bq": zeros(L, d),
                "wk": dense_init(gen, d, d, device, dtype, (L,)),
                "wv": dense_init(gen, d, d, device, dtype, (L,)), "bv": zeros(L, d),
                "wo": dense_init(gen, d, d, device, dtype, (L,)), "bo": zeros(L, d),
            },
            "ln2": {"w": ones(L, d), "b": zeros(L, d)},
            "mlp": {
                "w1": dense_init(gen, d, 4 * d, device, dtype, (L,)), "b1": zeros(L, 4 * d),
                "w2": dense_init(gen, 4 * d, d, device, dtype, (L,)), "b2": zeros(L, d),
            },
        },
        "ln_post": {"w": ones(d), "b": zeros(d)},
    }


def conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """x (B, T, C_in), w (K, C_in, C_out), padding 1 each side → (B, T', C_out)."""
    with full_f32():
        out = F.conv1d(x.transpose(1, 2), w.to(x.dtype).permute(2, 1, 0),
                       b.to(x.dtype), stride=stride, padding=1)
    return out.transpose(1, 2)


def _block_forward(cfg: WhisperEncoderConfig, blk, x: torch.Tensor) -> torch.Tensor:
    B, T, d = x.shape
    hd = d // cfg.n_heads
    a = blk["attn"]
    h = layer_norm(x, blk["ln1"]["w"], blk["ln1"]["b"])
    q = linear(h, a["wq"], a["bq"]).view(B, T, cfg.n_heads, hd).transpose(1, 2)
    k = linear(h, a["wk"]).view(B, T, cfg.n_heads, hd).transpose(1, 2)
    v = linear(h, a["wv"], a["bv"]).view(B, T, cfg.n_heads, hd).transpose(1, 2)
    out = flash_attention(q, k, v, None, causal=False)
    out = out.transpose(1, 2).reshape(B, T, d)
    x = x + linear(out, a["wo"], a["bo"])
    h = layer_norm(x, blk["ln2"]["w"], blk["ln2"]["b"])
    m = blk["mlp"]
    return x + linear(gelu(linear(h, m["w1"], m["b1"])), m["w2"], m["b2"])


def whisper_encode(cfg: WhisperEncoderConfig, params: Dict[str, Any], mel: torch.Tensor,
                   dtype=torch.float32) -> torch.Tensor:
    """Mel (B, n_mels, 3000) → (B, 1500, dim) encoder states."""
    x = mel.to(dtype).transpose(1, 2)
    x = gelu(conv1d(x, params["conv1"]["w"], params["conv1"]["b"], 1))
    x = gelu(conv1d(x, params["conv2"]["w"], params["conv2"]["b"], 2))
    x = x + params["positions"].to(dtype)[None, : x.shape[1]]
    blocks = params["blocks"]
    for l in range(cfg.n_layers):
        x = _block_forward(cfg, layer_at(blocks, l), x)
    return layer_norm(x, params["ln_post"]["w"], params["ln_post"]["b"])
