"""Weight-only int8 / int4 quantization and the int8 KV cache.

Counterpart of ``icl_speech_text_llm_tpu/ops/quant.py``, with the same
arithmetic (f32, round half to even, the same clips) and the same tree
layout, so a JAX-quantized tree and a port-quantized one hold identical
bytes:

- int8 ``{"q": int8 (…, in, out), "s": f32 (…, out)}``, per output column;
- int4 ``{"q4": uint8 (…, in/2, out), "s": f32 (…, in/group, out)}``,
  group-wise, split-half packed: ``byte[i] = (q[i]+8) | (q[i+in/2]+8) << 4``;
- int8 KV rows with one f32 scale per cached (position, head).

``dequant_matmul`` is the model code's matmul. On a CUDA tensor, products
with at most 1024 rows (decode steps, small prefills) go to the hand-written
kernels of ``ops/int4_matmul.py`` (K10 int4, W8A16 int8); larger products
take the JAX package's XLA route, a dequantized bf16 weight and a plain
matmul. On the CPU every product takes that plain route, as the JAX package
does off the TPU.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from .int4_matmul import int4_matmul, int4_matmul_usable, int8_matmul, int8_matmul_usable


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as one IEEE division, on either device: the divisor is a
    tensor on x's device, because on the card torch divides by a Python
    number as a multiply by its reciprocal, which can differ by one ulp (the
    JAX package and the quantizing append K4 q8 divide)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize_tensor(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(…, in, out) → {"q": int8, "s": f32 (…, out)}, per output column."""
    w = w.float()
    s = _div(w.abs().amax(dim=-2), 127.0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(w / s[..., None, :]), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_kv(kv: torch.Tensor):
    """int8 KV rows: (…, D) → (int8 (…, D), f32 scale (…)); an all-zero row
    gets scale 0 and dequantizes to 0."""
    kv = kv.float()
    scale = _div(kv.abs().amax(dim=-1), 127.0)
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    return torch.round(kv / safe[..., None]).to(torch.int8), scale


def quantize_tensor_int4(w: torch.Tensor, group: int = 128) -> Dict[str, torch.Tensor]:
    """(…, in, out) → {"q4": uint8 (…, in/2, out), "s": f32 (…, in/group, out)}:
    symmetric 4-bit with one scale per ``group`` input rows per column,
    split-half packed as value + 8 ∈ [1, 15]."""
    w = w.float()
    d_in, d_out = w.shape[-2], w.shape[-1]
    if d_in % group or d_in % 2 or (d_in // 2) % group:
        raise ValueError(f"d_in {d_in}: need d_in even and group {group} | d_in/2")
    lead = w.shape[:-2]
    wg = w.reshape(*lead, d_in // group, group, d_out)
    s = _div(wg.abs().amax(dim=-2), 7.0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(wg / s[..., None, :]), -7, 7).to(torch.int8)
    n = (q.reshape(*lead, d_in, d_out) + 8).to(torch.uint8)
    half = d_in // 2
    return {"q4": n[..., :half, :] | (n[..., half:, :] << 4), "s": s}


def _dequant_int4(w: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    """Unpack {"q4", "s"} → (…, in, out) weights in ``dtype`` (the scales are
    rounded to ``dtype`` before the product, as the JAX XLA route does)."""
    packed = w["q4"]
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    lead, half, out = packed.shape[:-2], packed.shape[-2], packed.shape[-1]
    q = torch.cat([lo, hi], dim=-2)
    n_groups = w["s"].shape[-2]
    group = (half * 2) // n_groups
    deq = q.reshape(*lead, n_groups, group, out).to(dtype)
    deq = deq * w["s"][..., None, :].to(dtype)
    return deq.reshape(*lead, half * 2, out)


def dequant_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain tensor or a quantized {"q", "s"} / {"q4", "s"} dict
    (2-D weight: one layer's view of a stacked tree)."""
    if not isinstance(w, dict):
        return torch.matmul(x, w.to(x.dtype))
    lead, K = x.shape[:-1], x.shape[-1]
    m = math.prod(lead)
    on_cuda = x.device.type == "cuda"
    if "q4" in w:
        if on_cuda and int4_matmul_usable((m, K), w["q4"].shape, w["s"].shape):
            y = int4_matmul(x.reshape(m, K), w["q4"], w["s"])
            return y.reshape(*lead, y.shape[-1])
        return torch.matmul(x, _dequant_int4(w, x.dtype))
    if on_cuda and int8_matmul_usable((m, K), w["q"].shape):
        y = int8_matmul(x.reshape(m, K), w["q"], w["s"])
        return y.reshape(*lead, y.shape[-1])
    return torch.matmul(x, w["q"].to(x.dtype)) * w["s"].to(x.dtype)


_DECODER_MATMULS = (
    ("layers", "attn", "wq"), ("layers", "attn", "wk"), ("layers", "attn", "wv"),
    ("layers", "attn", "wo"), ("layers", "mlp", "w_gate"), ("layers", "mlp", "w_up"),
    ("layers", "mlp", "w_down"),
)


def _int4_group(d_in: int, group: int):
    """The largest group ≤ ``group`` that divides half the input dim (split-half
    packing needs whole groups per nibble half), or None: int8 then."""
    if d_in % 2:
        return None
    return next((g for g in range(min(group, d_in // 2), 1, -1) if (d_in // 2) % g == 0), None)


def _quantize_stacked(w: torch.Tensor, bits: int, group: int) -> Dict[str, torch.Tensor]:
    """Quantize a stacked (L, in, out) weight one layer at a time into
    preallocated outputs: the f32 temporaries are one layer's, never the
    stack's (a 13B ``w_down`` in f32 is 11.3 GB)."""
    g = _int4_group(w.shape[-2], group) if bits == 4 else None
    fn = (lambda t: quantize_tensor_int4(t, group=g)) if g else quantize_tensor
    first = fn(w[0])
    out = {k: torch.empty((w.shape[0], *v.shape), dtype=v.dtype, device=v.device)
           for k, v in first.items()}
    for l in range(w.shape[0]):
        part = first if l == 0 else fn(w[l])
        for k, v in part.items():
            out[k][l] = v
    return out


def quantize_decoder(params: Dict[str, Any], include_lm_head: bool = True, bits: int = 8,
                     group: int = 128) -> Dict[str, Any]:
    """Quantize a decoder tree's matmul weights (the JAX package's tree).

    ``bits=8``: per-column int8. ``bits=4``: group-wise int4 with the largest
    group ≤ ``group`` that divides half the input dim, int8 where none does.
    Embeddings, norms and biases stay as they are; the lm_head is int8 at
    either width. Unlike the JAX function, the input tree is updated IN
    PLACE and returned: each bf16 stacked leaf is replaced as soon as its
    quantized form exists, so it is freed before the next one is built (the
    13B decoder is 26 GB in bf16)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    for path in _DECODER_MATMULS:
        node = params
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = _quantize_stacked(node[path[-1]], bits, group)
    if include_lm_head and "lm_head" in params:
        params["lm_head"] = quantize_tensor(params["lm_head"])
    return params
