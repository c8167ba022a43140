"""Attention ops: the plain masked attention and its masks.

Counterpart of ``icl_speech_text_llm_tpu/ops/attention.py``. The Q-Former
attends through ``dot_product_attention``; the encoders and the LLM prefill
go through the kernel-backed ops of ``ops/flash_attention.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, Hkv, T, D) → (B, Hkv*n_rep, T, D) for grouped-query attention."""
    if n_rep == 1:
        return x
    b, h, t, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, t, d).reshape(b, h * n_rep, t, d)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Masked scaled dot-product attention, softmax in f32.

    q (B, H, Tq, D); k/v (B, H, Tk, D); mask broadcastable to (B, H, Tq, Tk),
    True = attend. Returns (B, H, Tq, D) in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v)
    return out.to(q.dtype)


def causal_mask(tq: int, tk: int, offset: int = 0, device=None) -> torch.Tensor:
    """(1, 1, tq, tk) lower-triangular mask; query i attends keys ≤ i+offset."""
    qi = torch.arange(tq, device=device)[:, None] + offset
    kj = torch.arange(tk, device=device)[None, :]
    return (kj <= qi)[None, None]


def make_prefill_mask(lengths: torch.Tensor, seq_len: int) -> torch.Tensor:
    """Causal + right-padding mask for a packed prefill, (B, 1, S, S) bool."""
    causal = causal_mask(seq_len, seq_len, device=lengths.device)
    valid_k = (torch.arange(seq_len, device=lengths.device)[None, :]
               < lengths[:, None])[:, None, None]
    return causal & valid_k


def make_decode_mask(lengths: torch.Tensor, cache_len: int) -> torch.Tensor:
    """(B, 1, 1, cache_len) mask for single-token decode: positions < length."""
    return (torch.arange(cache_len, device=lengths.device)[None, :]
            < lengths[:, None])[:, None, None]
