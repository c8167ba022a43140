"""Shared model building blocks: init helpers, norms, GELU, RoPE, sinusoids.

Counterpart of ``icl_speech_text_llm_tpu/models/common.py``. Parameters are
plain nested dicts of tensors with the JAX package's key names and stacked
``(L, ...)`` layer leaves, so ``bridge.params_from_numpy`` copies a JAX tree
name for name.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_f32():
    """f32 matmuls and convolutions in full f32 inside the block: TF32 off
    for both cuBLAS and cuDNN (cuDNN convolutions default to TF32)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, device, dtype,
               lead=()) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, stored (in_dim, out_dim) so forward
    is x @ W; ``lead`` adds stacked axes. Drawn in f32, one leading slice at a
    time, then cast."""
    out = torch.empty((*lead, in_dim, out_dim), device=device, dtype=dtype)
    flat = out.view(-1, in_dim, out_dim)
    for i in range(flat.shape[0]):
        w = torch.empty((in_dim, out_dim), device=device, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        flat[i].copy_(w * in_dim ** -0.5)
    return out


def normal_init(gen: torch.Generator, shape, std: float, device, dtype) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * std
    return w.to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32, cast back to the input dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (biased variance), cast back to the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * weight.float() + bias.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU keyed on dtype, as in the JAX package: exact erf in f32, the tanh
    approximation under bf16/f16 (within one bf16 ulp of exact)."""
    approx = x.dtype in (torch.bfloat16, torch.float16)
    return F.gelu(x, approximate="tanh" if approx else "none")


def rope_frequencies(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    """Inverse frequencies for rotary embeddings, (head_dim // 2,)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
                  ).astype(np.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate (B, H, T, D) by per-position angles (half-split convention).
    positions: (B, T) or (T,)."""
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[:, :, None].float() * inv_freq[None, None, :]
    cos = torch.cos(angles)[:, None]
    sin = torch.sin(angles)[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Whisper-style sinusoidal position table, (length, dim)."""
    log_timescale = np.log(10000.0) / (dim // 2 - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(dim // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def layer_at(tree, l: int):
    """Layer ``l``'s view of a stacked (L, ...) parameter tree (the loop that
    replaces the JAX package's ``lax.scan`` over layers)."""
    if isinstance(tree, dict):
        return {k: layer_at(v, l) for k, v in tree.items()}
    return tree[l]


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x @ w (+ b) in x's dtype — the JAX package casts weights at use."""
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y
