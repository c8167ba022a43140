"""Sequence parallelism for the decoder: activations cut along T.

Counterpart of ``icl_speech_text_llm_tpu/parallel/sequence_parallel.py``:
every rank of the mesh axis holds whole layers and runs the whole stack on
its T/n slice of the sequence (projections, norms and MLPs are per
position), and each layer's attention is the ring
(``ring_attention._ring_attention_local``) with the rank's query offset,
so activations and KV both take 1/n of the memory a rank would need alone.

Gradients: a rank's slice of the output depends on the layers and on its
slice of the input, so under autograd every trainable leaf (and the
input, outside the rank's slice zero) gets this rank's partial
gradient; their sum over the axis is the whole gradient. The train step
sums them over the axis (``training/step.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models import llama  # a module: llama imports this package in turn
from ..models.common import rms_norm
from . import collectives as C
from .mesh import axis_group, axis_rank, axis_size
from .ring_attention import _ring_attention_local
from .sharding import shard_context


def sp_slice(mesh, axis: str, T: int) -> slice:
    """This rank's positions of a length-T sequence cut over ``axis``."""
    n = axis_size(mesh, axis)
    if T % n:
        raise ValueError(f"seq len {T} not divisible by {axis}={n}")
    size = T // n
    return slice(axis_rank(mesh, axis) * size, (axis_rank(mesh, axis) + 1) * size)


def sp_hidden(mesh, axis: str, cfg: llama.DecoderConfig, params: Dict[str, Any],
              inputs_embeds: torch.Tensor, lengths: torch.Tensor,
              lora: Optional[Dict[str, Any]] = None, lora_scaling: float = 1.0,
              remat=False) -> torch.Tensor:
    """The final-normed hidden of this rank's slice (``sp_slice``) of a
    causal decoder forward: inputs_embeds (B, T, dim) whole on every rank,
    ``lengths`` (B,) the valid lengths (causal and length masking)."""
    rows = sp_slice(mesh, axis, inputs_embeds.shape[1])
    group = axis_group(mesh, axis)
    x = inputs_embeds[:, rows]
    B, T_local, _ = x.shape
    positions = torch.arange(rows.start, rows.stop, device=x.device)[None].expand(B, T_local)
    sm_scale = cfg.hd ** -0.5

    def attn(q, k, v, layer):
        return _ring_attention_local(q, k, v, lengths, group, causal=True, sm_scale=sm_scale,
                                     q_offset=rows.start, layer=layer)

    with shard_context(None):  # whole layers on every rank
        hidden = llama.run_layer_stack(cfg, params["layers"], x, positions, lengths, lora,
                                       lora_scaling, remat, attn)
    return rms_norm(hidden, params["final_norm"], cfg.rms_eps)


def sp_decoder_forward(mesh, axis: str, cfg: llama.DecoderConfig, params: Dict[str, Any],
                       inputs_embeds: torch.Tensor, lengths: torch.Tensor,
                       lora: Optional[Dict[str, Any]] = None, lora_scaling: float = 1.0,
                       remat=False) -> torch.Tensor:
    """Causal decoder forward with sequence-cut activations: equal to
    ``decoder_forward(...)[0]`` with per-sample ``lengths``, the (B, T, dim)
    hidden gathered whole on every rank (T % the axis size == 0). Under
    autograd each rank back-propagates its own slice's gradient: the
    input's and every leaf's gradient are partial sums over the axis."""
    hidden = sp_hidden(mesh, axis, cfg, params, inputs_embeds, lengths, lora, lora_scaling,
                       remat)
    return C.GatherDim.apply(hidden, 1, axis_group(mesh, axis))
