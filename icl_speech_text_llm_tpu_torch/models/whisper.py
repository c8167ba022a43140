"""Whisper audio encoder in PyTorch.

Counterpart of ``icl_speech_text_llm_tpu/models/whisper.py``: conv1(k3,s1)
→ gelu → conv2(k3,s2) → gelu → +sinusoid positions → N pre-LN blocks (MHA
with biases, GELU MLP) → final LN; (B, n_mels, 2T) mel in, (B, T, dim) out:
SALMONN's 3000 mel frames give 1500. Self-attention goes through the
non-causal flash op over the T real frames: the kernel masks the ragged
last tile itself, so the 1500→1536 padding of the Pallas path is gone.
Qwen2-Audio's tower passes each clip's valid frame count (K2's key
lengths), a mel cut short to its batch's longest clip
(``models/qwen_audio.py:encode_audio``), and takes the states before the
final LN.

Under a mesh (``parallel/sharding.py``) the blocks' wq/wk/wv/w1 are
column-parallel and wo/w2 row-parallel over tp, FSDP-sharded leaves are
gathered at each block's start, and K2 runs on the rank's heads; the
biases match no rule and are whole: bq/bv/b1 are sliced to the rank's
columns, and the row-parallel products' bo/b2 are added once, by tp rank
0 before the sum over tp. Where tp does not divide the heads (large-v2's
20 at tp = 8) the block takes the split-head path
(``ShardContext.split_heads``): the q/k/v column blocks are gathered over
tp into whole heads, K2 runs over all of them on every rank, and the
rank's columns of its output enter wo.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention
from ..parallel.sharding import ONE, current_shard
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


def _block_forward(cfg: WhisperEncoderConfig, blk, x: torch.Tensor,
                   lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One pre-LN block; under a mesh on this tp rank's heads and MLP
    columns (with one process every slice is whole and every sum the
    identity)."""
    sh = current_shard() or ONE
    blk = sh.gather_fsdp(blk, "whisper/blocks")
    B, T, d = x.shape
    split = sh.split_heads(cfg.n_heads)
    H, hd = sh.local_heads(cfg.n_heads, split), d // cfg.n_heads
    cols = sh.cols(d)
    a = blk["attn"]
    h = layer_norm(x, blk["ln1"]["w"], blk["ln1"]["b"])
    qkv = (linear(h, a["wq"], a["bq"][cols]), linear(h, a["wk"]),
           linear(h, a["wv"], a["bv"][cols]))
    if split:
        qkv = sh.gather_cols(*qkv)
    q, k, v = (t.view(B, T, H, hd).transpose(1, 2) for t in qkv)
    # keys past lengths[b] masked; rows past it are garbage the caller drops
    out = flash_attention(q, k, v, lengths, causal=False)
    out = out.transpose(1, 2).reshape(B, T, H * hd)
    if split:
        out = out[..., cols]
    x = x + sh.reduce_from_tp(linear(out, a["wo"], sh.row_bias(a["bo"])))
    h = layer_norm(x, blk["ln2"]["w"], blk["ln2"]["b"])
    m = blk["mlp"]
    up = gelu(linear(h, m["w1"], m["b1"][sh.cols(m["b1"].shape[-1])]))
    return x + sh.reduce_from_tp(linear(up, m["w2"], sh.row_bias(m["b2"])))


def whisper_encode(cfg: WhisperEncoderConfig, params: Dict[str, Any], mel: torch.Tensor,
                   dtype=torch.float32, apply_ln_post: bool = True,
                   frame_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mel (B, n_mels, 2T) → (B, T, dim) encoder states: the 30-s mel's
    3000 frames give 1500, a mel cut to its first 2T frames the first T
    positions (the table's first T rows).

    ``apply_ln_post=False`` returns the states before the final LN
    (Qwen2-Audio pools first). ``frame_lengths`` (B,) masks self-attention
    keys past each clip's valid post-conv frames (Qwen2-Audio's
    ``feature_attention_mask``); rows past a clip's length are garbage.
    Without it every row attends every frame, so a cut mel would change
    the rows it keeps: SALMONN passes the whole 3000."""
    x = mel.to(dtype).transpose(1, 2)
    x = gelu(conv1d(x, params["conv1"]["w"], params["conv1"]["b"], 1))
    x = gelu(conv1d(x, params["conv2"]["w"], params["conv2"]["b"], 2))
    x = x + params["positions"].to(dtype)[None, : x.shape[1]]
    lengths = None if frame_lengths is None else frame_lengths.to(x.device, torch.int32)
    blocks = params["blocks"]
    for l in range(cfg.n_layers):
        x = _block_forward(cfg, layer_at(blocks, l), x, lengths)
    if not apply_ln_post:
        return x
    return layer_norm(x, params["ln_post"]["w"], params["ln_post"]["b"])
