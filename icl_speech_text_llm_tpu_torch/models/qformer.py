"""Window-level Q-Former: the audio→LLM bridge, in PyTorch.

Counterpart of ``icl_speech_text_llm_tpu/models/qformer.py``: encoder
features (B, 1500, C) are cut into ``n_windows`` windows of ``window``
frames; ``n_query`` learned queries attend each window through a BERT-style
post-LN stack (self-attn, cross-attn, FFN) and project to the LLM width —
88 positions per 30 s clip, all windows of all clips in one batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from ..ops.attention import dot_product_attention
from .common import dense_init, gelu, layer_at, layer_norm, linear, normal_init


@dataclass(frozen=True)
class QFormerConfig:
    encoder_width: int = 2048  # whisper 1280 + beats 768
    dim: int = 768
    n_heads: int = 12
    n_layers: int = 2
    n_query: int = 1
    window: int = 17
    n_windows: int = 88
    llm_dim: int = 5120
    mlp_ratio: int = 4


QFORMER_CONFIGS: Dict[str, QFormerConfig] = {
    "salmonn": QFormerConfig(),
    "salmonn-7b": QFormerConfig(llm_dim=4096),
    "tiny-test": QFormerConfig(encoder_width=96, dim=32, n_heads=4, n_layers=2, llm_dim=128),
}


def init_qformer(cfg: QFormerConfig, gen: torch.Generator, device, dtype) -> Dict[str, Any]:
    d, ew, L, inner = cfg.dim, cfg.encoder_width, cfg.n_layers, cfg.mlp_ratio * cfg.dim

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def dense(i, o, lead=(L,)):
        return dense_init(gen, i, o, device, dtype, lead)

    def attn(kv_in):
        return {"wq": dense(d, d), "bq": zeros(L, d), "wk": dense(kv_in, d), "bk": zeros(L, d),
                "wv": dense(kv_in, d), "bv": zeros(L, d), "wo": dense(d, d), "bo": zeros(L, d)}

    return {
        "query_tokens": normal_init(gen, (cfg.n_query, d), 0.02, device, dtype),
        "ln_input": {"w": ones(ew), "b": zeros(ew)},
        "layers": {
            "self_attn": attn(d),
            "ln_self": {"w": ones(L, d), "b": zeros(L, d)},
            "cross_attn": attn(ew),
            "ln_cross": {"w": ones(L, d), "b": zeros(L, d)},
            "mlp": {"w1": dense(d, inner), "b1": zeros(L, inner),
                    "w2": dense(inner, d), "b2": zeros(L, d)},
            "ln_mlp": {"w": ones(L, d), "b": zeros(L, d)},
        },
        "proj": {"w": dense(d, cfg.llm_dim, ()), "b": zeros(cfg.llm_dim)},
    }


def _mha(cfg: QFormerConfig, p, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
    Bq, Tq, _ = q_in.shape
    Tk = kv_in.shape[1]
    d, H = cfg.dim, cfg.n_heads
    hd = d // H
    q = linear(q_in, p["wq"], p["bq"]).view(Bq, Tq, H, hd).transpose(1, 2)
    k = linear(kv_in, p["wk"], p["bk"]).view(Bq, Tk, H, hd).transpose(1, 2)
    v = linear(kv_in, p["wv"], p["bv"]).view(Bq, Tk, H, hd).transpose(1, 2)
    out = dot_product_attention(q, k, v).transpose(1, 2).reshape(Bq, Tq, d)
    return linear(out, p["wo"], p["bo"])


def _layer_forward(cfg: QFormerConfig, layer, q: torch.Tensor, windows: torch.Tensor):
    q = layer_norm(q + _mha(cfg, layer["self_attn"], q, q),
                   layer["ln_self"]["w"], layer["ln_self"]["b"])
    q = layer_norm(q + _mha(cfg, layer["cross_attn"], q, windows),
                   layer["ln_cross"]["w"], layer["ln_cross"]["b"])
    m = layer["mlp"]
    h = linear(gelu(linear(q, m["w1"], m["b1"])), m["w2"], m["b2"])
    return layer_norm(q + h, layer["ln_mlp"]["w"], layer["ln_mlp"]["b"])


def qformer_windows(cfg: QFormerConfig, params: Dict[str, Any],
                    features: torch.Tensor) -> torch.Tensor:
    """(B, T, C) encoder features → (B, n_windows * n_query, llm_dim)."""
    B = features.shape[0]
    x = layer_norm(features, params["ln_input"]["w"], params["ln_input"]["b"])
    usable = cfg.n_windows * cfg.window
    windows = x[:, :usable].reshape(B * cfg.n_windows, cfg.window, cfg.encoder_width)
    q = params["query_tokens"].to(x.dtype)[None].expand(
        B * cfg.n_windows, cfg.n_query, cfg.dim)
    for l in range(cfg.n_layers):
        q = _layer_forward(cfg, layer_at(params["layers"], l), q, windows)
    out = linear(q, params["proj"]["w"], params["proj"]["b"])
    return out.reshape(B, cfg.n_windows * cfg.n_query, cfg.llm_dim)
