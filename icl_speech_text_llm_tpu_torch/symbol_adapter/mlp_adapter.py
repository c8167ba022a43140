"""MLP symbol-discovery adapter in PyTorch.

Counterpart of ``icl_speech_text_llm_tpu/symbol_adapter/mlp_adapter.py``
(ref: models/mlp_salmonn_old.py:98-123 MLP stacks; :213-316 soft/hard
vocab-similarity quantization + discovery collection):

- input/output MLPs: Linear(D,H) → LayerNorm → exact GELU → Linear(H,D),
  applied residually (x + MLP(x)) at label-token positions only;
- quantization against the vocabulary embedding matrix: cosine
  similarities, a softmax(sim/T) mixture of the vocabulary for training or
  an argmax snap to one row;
- discovery: per-position argmax token ids and similarities come back as
  tensors; the host accumulates the discovered-mappings dict.

The similarity product and the mixture are plain matrix products (the JAX
package computes them outside any Pallas kernel): ``torch.matmul``, with
JAX's dtypes — similarities in x's dtype, the softmax and the mixture in
f32 — and ``torch.argmax``'s first maximum, as ``jnp.argmax`` takes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.common import dense_init, layer_norm, linear


def init_mlp_adapter(gen: torch.Generator, embed_dim: int, hidden_dim: Optional[int] = None,
                     device="cuda", dtype=torch.float32) -> Dict[str, Any]:
    """Two symmetric MLPs (input + output), ref :108-123, drawn from ``gen``
    on ``device`` (input_mlp's w1, w2, then output_mlp's)."""
    hidden_dim = hidden_dim or embed_dim

    def one():
        return {
            "w1": dense_init(gen, embed_dim, hidden_dim, device, dtype),
            "b1": torch.zeros((hidden_dim,), device=device, dtype=dtype),
            "ln": {"w": torch.ones((hidden_dim,), device=device, dtype=dtype),
                   "b": torch.zeros((hidden_dim,), device=device, dtype=dtype)},
            "w2": dense_init(gen, hidden_dim, embed_dim, device, dtype),
            "b2": torch.zeros((embed_dim,), device=device, dtype=dtype),
        }

    return {"input_mlp": one(), "output_mlp": one()}


def mlp_forward(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Linear → LayerNorm (f32) → GELU → Linear in x's dtype. The GELU is
    the exact erf one at every dtype, as the reference's
    ``jax.nn.gelu(approximate=False)`` (not ``models.common.gelu``, which
    takes the tanh form under bf16)."""
    h = linear(x, p["w1"], p["b1"])
    h = layer_norm(h, p["ln"]["w"], p["ln"]["b"])
    h = F.gelu(h, approximate="none")
    return linear(h, p["w2"], p["b2"])


def _unit(t: torch.Tensor) -> torch.Tensor:
    return t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-8)


def quantize_to_vocab(
    x: torch.Tensor,  # (..., D)
    vocab_embeds: torch.Tensor,  # (V, D)
    temperature: float = 0.1,
    hard: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cosine-similarity quantization (ref :222-243).

    Returns (quantized_embeddings, argmax_token_ids, argmax_similarities)."""
    xn = _unit(x)
    sims = torch.matmul(xn, _unit(vocab_embeds).T.to(xn.dtype))  # (..., V)
    hard_ids = torch.argmax(sims, dim=-1)  # the first maximum, as jnp.argmax
    hard_sims = torch.amax(sims, dim=-1)
    if hard:
        quantized = vocab_embeds[hard_ids].to(x.dtype)
    else:
        weights = torch.softmax(sims.float() / temperature, dim=-1)
        quantized = torch.matmul(weights, vocab_embeds.float()).to(x.dtype)
    return quantized, hard_ids, hard_sims


def transform_label_embeddings(
    mlp_params: Dict[str, Any],
    embeds: torch.Tensor,  # (B, L, D)
    label_mask: torch.Tensor,  # (B, L) bool — positions holding symbol tokens
    vocab_embeds: torch.Tensor,  # (V, D)
    temperature: float = 0.1,
    hard: bool = False,
    bypass: bool = False,
    quantize: bool = True,
    which: str = "input_mlp",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residual MLP transform + vocab quantization at masked positions
    (ref :235-316: X̂ ← X + MLP(X), then quantize X̂ against the vocab).

    Returns (new_embeds, discovered_ids (B, L) int32, similarities (B, L));
    outside the mask embeds pass through, ids are -1 and similarities 0."""
    B, L, _ = embeds.shape
    if bypass:
        return (embeds, torch.full((B, L), -1, dtype=torch.int32, device=embeds.device),
                torch.zeros((B, L), dtype=embeds.dtype, device=embeds.device))

    transformed = embeds + mlp_forward(mlp_params[which], embeds)
    if quantize:
        quantized, ids, sims = quantize_to_vocab(transformed, vocab_embeds, temperature, hard)
    else:
        quantized = transformed
        ids = torch.zeros((B, L), dtype=torch.int64, device=embeds.device)
        sims = torch.zeros((B, L), dtype=embeds.dtype, device=embeds.device)

    label_mask = label_mask.bool()
    out = torch.where(label_mask[..., None], quantized, embeds)
    ids = torch.where(label_mask, ids, torch.full_like(ids, -1)).to(torch.int32)
    sims = torch.where(label_mask, sims, torch.zeros_like(sims))
    return out, ids, sims


def label_token_mask(text_tokens, symbol_token_ids) -> np.ndarray:
    """Host helper: mark positions whose token id belongs to any symbol.

    text_tokens: (B, L_text) int array; symbol_token_ids: iterable of ints."""
    ids = np.asarray(sorted(set(int(i) for i in symbol_token_ids)), np.int64)
    if ids.size == 0:
        return np.zeros(np.asarray(text_tokens).shape, bool)
    return np.isin(np.asarray(text_tokens), ids)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def collect_discoveries(
    discovered_ids, similarities, text_tokens, tokenizer
) -> Dict[int, Dict[str, Any]]:
    """Host-side discovery accumulation (ref :245-316): original token id →
    {discovered token id, texts, similarity}. Takes tensors on any device or
    arrays."""
    ids, sims, toks = (_host(a) for a in (discovered_ids, similarities, text_tokens))
    out: Dict[int, Dict[str, Any]] = {}
    for b in range(ids.shape[0]):
        for l in range(ids.shape[1]):
            if ids[b, l] < 0:
                continue
            orig = int(toks[b, l])
            disc = int(ids[b, l])
            out[orig] = {
                "discovered_token": disc,
                "similarity": float(sims[b, l]),
                "random_text": tokenizer.decode([orig], skip_special_tokens=True),
                "discovered_text": tokenizer.decode([disc], skip_special_tokens=True),
            }
    return out
