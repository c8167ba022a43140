"""Decoder-only transformer (LLaMA/Vicuna, Qwen2 config space) in PyTorch.

Counterpart of ``icl_speech_text_llm_tpu/models/llama.py`` for the static
engine's inference path and the training forward: stacked ``(L, ...)``
layer weights walked by a Python loop, grouped-query attention with RoPE,
LoRA added inside the q/v projections, and a KV cache updated in place.

- ``decoder_forward`` is the causal prefill: attention goes through the
  causal flash op with per-sample lengths (GQA without a repeated copy),
  and each layer's k/v land in the cache as they are computed. Without a
  cache it is the training forward: nothing is written in place, autograd
  differentiates it (the flash op's backward is the K5/K6 kernels), and
  ``remat`` recomputes layers in the backward as the JAX package's
  ``jax.checkpoint`` options do. With ``cache_positions`` it prefills over
  an existing cache (serving's suffix and chunk prefills): sample b's k/v
  land at [cache_positions[b], cache_positions[b] + T), quantized under an
  int8 cache, and its queries attend the whole cache, dequantized, under
  ``make_chunk_mask`` with the plain ``dot_product_attention``, as the JAX
  package does on every backend (no Pallas kernel computes it).
- ``decode_step`` is the single-token cached step of the JAX package's
  ``_decode_step_zero_copy``: each layer attends its cache slice
  ``cache_k[l]`` read-only with the current token folded in as one extra
  column, and ONE append writes every layer's new k/v after the loop
  (``append_kv``, K4). The attention is ``DecodeAttention.XLA``
  (``_xla_decode_attn``, JAX's default ``"xla"`` math) or
  ``DecodeAttention.FLASH`` (the K7 flash-decode kernel, JAX's
  ``use_flash_decode=True``; its plain version on the CPU) where
  ``flash_decode_usable`` admits the shapes, else the same math as
  ``XLA``, as JAX's generic path. With an int8 cache
  (``init_kv_cache(quant=True)``) the append is ``append_kv_q8`` (K4 q8),
  which quantizes the new rows per (position, head) and writes their
  scales beside them in the same launch; K7 q8 attends the cache where
  ``q8_cache_layout_ok`` admits its layout, else the ``XLA`` math does. The
  current token is attended unquantized, the cache through its scales.

- ``DecodeAttention.GENERIC`` (JAX's ``use_flash_decode=False``) is the
  scanned-layer decode: each layer first writes its new k/v row into the
  cache (K4, or K4 q8 quantizing it, on that layer's slice), then attends
  the (dequantized) cache under the decode mask with the plain
  ``dot_product_attention``, so under an int8 cache the current token is
  attended quantized, unlike the ``XLA`` route.

Under a mesh (``parallel/sharding.py:current_shard()``; None on one
process, where nothing below changes) every rank holds its local blocks
by the rule table and the layer code calls explicit collectives: wq, wk,
wv, w_gate, w_up (and Qwen's bq/bk/bv) are column-parallel over the rank's
heads and columns, wo and w_down row-parallel followed by an all-reduce in
f32 (Megatron's pair: the column blocks' inputs sum their gradient over
tp), LoRA A/B cut to match, a tp-replicated trainable factor summing its
gradient over tp. A quantized weight matches no rule and stays replicated:
its rank computes the full product and keeps its columns, or all-gathers
the heads before a row-side one. The vocabulary is tp-sharded: a masked
lookup plus an all-reduce, vocab-sharded logits (gathered for decoding),
and a vocab-parallel cross entropy. FSDP-sharded leaves are gathered at
their layer's start, and the backward keeps only the frozen ones' shards
(``ShardContext.keep_shards``: gathered again when it needs them; a
checkpointed layer's recompute gathers anew). On the head-sharded path
K1, K5/K6, K7 and K4 see only the rank's heads, and the KV cache holds the
rank's KV heads. Where tp does not divide the heads or the KV heads
(``ShardContext.split_heads``; ``_local_cfg`` then gives a
``SplitHeadConfig``) the q/k/v column blocks are gathered over tp into
whole heads (one all-gather a layer, a reduce-scatter backward), K1,
K5/K6 and K4 run over every head on every rank, the cache holds every KV
head, the decode step takes the plain math where ``FLASH`` would take K7
(JAX's gate under a mesh), and the attention output is cut back to the
rank's columns for its wo row shard.

Matmul weights may be plain tensors or the JAX package's quantized dicts
(int8 ``{"q", "s"}``, int4 ``{"q4", "s"}``): every product goes through
``ops/quant.py:dequant_matmul``. ``lora`` is one adapter (leaves (L, d_in,
r) / (L, r, d_out)) or, with ``lora_ids`` (B,), a ``stack_lora_bank`` of
several (leaves (L, n_adapters, ...)), each sample applying its own.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import functools
import logging
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.flash_attention import (
    append_kv,
    append_kv_q8,
    flash_attention,
    flash_decode_attention,
    flash_decode_attention_q8,
    flash_decode_usable,
    q8_cache_layout_ok,
)
from ..ops.attention import (
    dot_product_attention,
    make_chunk_mask,
    make_decode_mask,
    repeat_kv,
)
from ..ops.quant import dequant_matmul, quantize_kv
from ..parallel.sharding import current_shard
from .common import (
    apply_rope,
    dense_init,
    layer_at,
    normal_init,
    rms_norm,
    rope_frequencies,
)

logger = logging.getLogger(__name__)


def _warn_remat_degraded(remat, n_layers: int, why: str) -> None:
    """A requested '1inK' spec silently becoming full per-layer remat would
    make backward-recompute regressions untraceable — say so once."""
    logger.warning(
        "remat=%r degraded to full per-layer remat (%s; n_layers=%d): "
        "backward recompute will NOT drop by 1/K", remat, why, n_layers)


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


def init_decoder_quantized(cfg: DecoderConfig, gen: torch.Generator, device,
                           dtype=torch.bfloat16, bits: int = 8, group: int = 128) -> Dict[str, Any]:
    """Random-init decoder directly in the int8/int4 serving layout (the tree
    ``quantize_decoder`` gives, never a full-precision weight): random bytes
    drawn layer by layer, the JAX package's constant scales, f32 norms and
    biases, ``dtype`` embeddings, an int8 lm_head."""
    L, hd = cfg.n_layers, cfg.hd
    q_out, kv_out = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def qtensor(d_in, d_out):
        if bits == 4:
            packed = torch.empty((L, d_in // 2, d_out), dtype=torch.uint8, device=device)
            for l in range(L):
                packed[l] = torch.randint(0, 256, (d_in // 2, d_out), generator=gen,
                                          dtype=torch.uint8, device=device)
            s = torch.full((L, d_in // group, d_out), (d_in ** -0.5) / 4.6,  # nibble std ≈ 4.6
                           dtype=torch.float32, device=device)
            return {"q4": packed, "s": s}
        q = torch.empty((L, d_in, d_out), dtype=torch.int8, device=device)
        for l in range(L):
            q[l] = torch.randint(-127, 128, (d_in, d_out), generator=gen, dtype=torch.int8,
                                 device=device)
        s = torch.full((L, d_out), (d_in ** -0.5) / 127.0, dtype=torch.float32, device=device)
        return {"q": q, "s": s}

    def f32(fill, *shape):
        return torch.full(shape, fill, dtype=torch.float32, device=device)

    layers = {
        "attn": {"wq": qtensor(cfg.dim, q_out), "wk": qtensor(cfg.dim, kv_out),
                 "wv": qtensor(cfg.dim, kv_out), "wo": qtensor(q_out, cfg.dim)},
        "mlp": {"w_gate": qtensor(cfg.dim, cfg.hidden_dim),
                "w_up": qtensor(cfg.dim, cfg.hidden_dim),
                "w_down": qtensor(cfg.hidden_dim, cfg.dim)},
        "ln_attn": f32(1.0, L, cfg.dim),
        "ln_mlp": f32(1.0, L, cfg.dim),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", q_out), ("bk", kv_out), ("bv", kv_out)):
            layers["attn"][name] = f32(0.0, L, width)
    params = {
        "tok_embed": normal_init(gen, (cfg.vocab_size, cfg.dim), 0.02, device, dtype),
        "layers": layers,
        "final_norm": f32(1.0, cfg.dim),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {
            "q": torch.randint(-127, 128, (cfg.dim, cfg.vocab_size), generator=gen,
                               dtype=torch.int8, device=device),
            "s": f32((cfg.dim ** -0.5) / 127.0, cfg.vocab_size)}
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


def stack_lora_bank(adapters) -> Dict[str, Any]:
    """Stack same-shaped LoRA adapter trees (tensors or arrays) into a
    multi-adapter bank: leaves (n_layers, n_adapters, ...), the adapter axis
    after the layer axis, so each layer sees (n_adapters, d_in, r) to gather
    per-sample factors from (``lora_ids``)."""
    if not adapters:
        raise ValueError("stack_lora_bank needs at least one adapter")

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(d[k] for d in leaves)) for k in leaves[0]}
        return torch.stack([torch.as_tensor(x) for x in leaves], dim=1)

    return stack(*adapters)


def _proj(x, w, lora_layer, name: str, scaling: float, bias=None, lora_ids=None,
          row: bool = False):
    """x @ w (+ bias) with the optional additive LoRA delta ((x·A)·B)·scaling;
    ``w`` a tensor or a quantized dict (``dequant_matmul``). With
    ``lora_ids`` (B,) the layer's LoRA is a bank (n_adapters, d_in, r) and
    each sample gathers its own rank-r factors. ``row``: a row-parallel
    target (wo, w_down), which matters under tensor parallelism only."""
    sh = current_shard()
    if sh is not None and sh.tp > 1:
        return _proj_tp(sh, x, w, lora_layer, name, scaling, bias, lora_ids, row)
    y = dequant_matmul(x, w)
    if lora_layer is not None and name in lora_layer:
        a = lora_layer[name]["a"].to(x.dtype)
        b = lora_layer[name]["b"].to(x.dtype)
        if lora_ids is None:
            y = y + torch.matmul(torch.matmul(x, a), b) * scaling
        else:
            delta = torch.bmm(x, a.index_select(0, lora_ids))
            y = y + torch.bmm(delta, b.index_select(0, lora_ids)) * scaling
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def _proj_tp(sh, x, w, lora_layer, name, scaling, bias, lora_ids, row):
    """``_proj`` on this tp rank. Column (``row`` False): x whole, the
    rank's output columns. Row: x the rank's input columns (heads), the
    partial products summed over tp in f32. A quantized ``w`` is whole on
    every rank: the full product, then the rank's columns (column), or the
    heads gathered first and no sum (row). A LoRA bank (``lora_ids``) is
    whole on every rank, as under JAX: each sample's A and B are gathered,
    then cut to the rank's part, B's columns (column) or A's rows (row, its
    partial delta summed with the product's in the same reduce)."""
    whole = isinstance(w, dict)
    if row:
        y = dequant_matmul(sh.gather_tp(x, -1) if whole else x, w)
    else:
        y = dequant_matmul(x, w)
        if whole:
            y = y[..., sh.cols(y.shape[-1])]
    delta = None
    if lora_layer is not None and name in lora_layer:
        a, b = lora_layer[name]["a"], lora_layer[name]["b"]
        if lora_ids is not None:
            a, b = a.index_select(0, lora_ids), b.index_select(0, lora_ids)
            if row:
                a = a[:, sh.cols(a.shape[1])]
            else:
                b = b[..., sh.cols(b.shape[-1])]
            delta = torch.bmm(torch.bmm(x, a.to(x.dtype)), b.to(x.dtype)) * scaling
        else:
            # the factor whole on every tp rank multiplies a tp-sharded one:
            # its gradient is a partial sum over tp, summed in the factor's
            # own dtype (before the cast, so f32 master weights sum f32
            # gradients)
            a, b = (a, sh.copy_to_tp(b)) if row else (sh.copy_to_tp(a), b)
            delta = torch.matmul(torch.matmul(x, a.to(x.dtype)), b.to(x.dtype)) * scaling
    if row:
        if whole:
            y = y if delta is None else y + sh.reduce_from_tp(delta)
        else:
            y = sh.reduce_from_tp(y if delta is None else y + delta)
    elif delta is not None:
        y = y + delta
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


@dataclass(frozen=True)
class SplitHeadConfig(DecoderConfig):
    """A decoder config on the split-head path (tp does not divide its
    heads or its KV heads): every head, attended on every tp rank."""


def _local_cfg(cfg: DecoderConfig) -> DecoderConfig:
    """``cfg`` with this tp rank's heads and KV heads (head_dim kept), or
    as a ``SplitHeadConfig`` where tp does not divide them, or ``cfg``
    itself outside tensor parallelism."""
    sh = current_shard()
    if sh is None or sh.tp == 1:
        return cfg
    if sh.split_heads(cfg.n_heads, cfg.n_kv_heads):
        return SplitHeadConfig(**{**dataclasses.asdict(cfg), "head_dim": cfg.hd})
    return dataclasses.replace(cfg, n_heads=sh.local_heads(cfg.n_heads),
                               n_kv_heads=sh.local_heads(cfg.n_kv_heads), head_dim=cfg.hd)


def _gathered(layer, lo, bank: bool = False):
    """A layer's weights and LoRA with their FSDP shards gathered (as they
    are without a mesh); a LoRA ``bank`` is whole on every rank."""
    sh = current_shard()
    if sh is None:
        return layer, lo
    return sh.gather_fsdp(layer, "llm/layers"), lo if bank else sh.gather_fsdp(lo, "lora")


def _tp_input(h):
    """The input of a column-parallel block: its gradient summed over tp."""
    sh = current_shard()
    return h if sh is None else sh.copy_to_tp(h)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _qkv_heads(cfg, layer, lora_layer, lora_scaling, x, positions, inv_freq, lora_ids=None):
    """Pre-norm, q/k/v projections, head split and RoPE → (B, H|Hkv, T, hd)."""
    B, T, _ = x.shape
    hd = cfg.hd
    attn = layer["attn"]
    pj = functools.partial(_proj, lora_ids=lora_ids)
    h = _tp_input(rms_norm(x, layer["ln_attn"], cfg.rms_eps))
    q = pj(h, attn["wq"], lora_layer, "wq", lora_scaling, attn.get("bq"))
    k = pj(h, attn["wk"], lora_layer, "wk", lora_scaling, attn.get("bk"))
    v = pj(h, attn["wv"], lora_layer, "wv", lora_scaling, attn.get("bv"))
    if isinstance(cfg, SplitHeadConfig):  # the rank's column blocks → whole heads
        q, k, v = current_shard().gather_cols(q, k, v)
    q = q.view(B, T, cfg.n_heads, hd).transpose(1, 2)
    k = k.view(B, T, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.view(B, T, cfg.n_kv_heads, hd).transpose(1, 2)
    return apply_rope(q, positions, inv_freq), apply_rope(k, positions, inv_freq), v


def _attn_out_mlp(cfg, layer, lora_layer, lora_scaling, x, out, lora_ids=None):
    """Attention output projection + residual + SwiGLU MLP block; on the
    split-head path the rank's columns of the whole heads' ``out`` enter
    its wo row shard."""
    attn, mlp = layer["attn"], layer["mlp"]
    pj = functools.partial(_proj, lora_ids=lora_ids)
    if isinstance(cfg, SplitHeadConfig):
        out = out[..., current_shard().cols(out.shape[-1])]
    x = x + pj(out, attn["wo"], lora_layer, "wo", lora_scaling, row=True)
    h = _tp_input(rms_norm(x, layer["ln_mlp"], cfg.rms_eps))
    gate = pj(h, mlp["w_gate"], lora_layer, "w_gate", lora_scaling)
    up = pj(h, mlp["w_up"], lora_layer, "w_up", lora_scaling)
    return x + pj(F.silu(gate) * up, mlp["w_down"], lora_layer, "w_down", lora_scaling,
                  row=True)


def _inv_freq(cfg: DecoderConfig, device) -> torch.Tensor:
    return torch.from_numpy(rope_frequencies(cfg.hd, cfg.rope_theta)).to(device)


def init_kv_cache(cfg: DecoderConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  device="cuda", quant: bool = False) -> Dict[str, torch.Tensor]:
    """Stacked KV cache {"k", "v"}: (L, B, Hkv, max_len, hd). ``quant``: int8
    k/v and f32 per-position scales {"k_s", "v_s"} (L, B, Hkv, max_len).
    Under tensor parallelism Hkv is the rank's KV heads (every KV head on
    the split-head path)."""
    cfg = _local_cfg(cfg)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    if quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                "v_s": torch.zeros(shape[:-1], dtype=torch.float32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _mixed_remat_group(remat) -> int:
    """0 when ``remat`` is not a "1inK" spec, else K (>= 2)."""
    if isinstance(remat, str) and remat.startswith("1in"):
        g = int(remat[3:])
        if g < 2:
            raise ValueError(f"1inK remat needs K >= 2, got {remat!r}")
        return g
    return 0


#: "dots" remat saves the outputs of the weight matmuls (3-D activations
#: times 2-D weights dispatch as mm/addmm) and recomputes everything else,
#: the attention included: the counterpart of JAX's
#: ``dots_with_no_batch_dims_saveable``.
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED else CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(remat, fn):
    """``fn`` under per-layer activation checkpointing: ``True`` recomputes
    the whole layer in the backward, ``"dots"`` recomputes all but the
    weight-matmul outputs."""
    kw = {"use_reentrant": False}
    if remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    elif remat is not True:
        raise ValueError(f"remat must be False, True, 'dots' or '1inK', got {remat!r}")
    return functools.partial(checkpoint, fn, **kw)


def _write_rows(plane, rows, starts):
    """plane (B, Hkv, S[, hd]) gets rows (B, Hkv, T[, hd]) at [starts[b],
    starts[b] + T) of sample b, in place."""
    B, Hkv, T = rows.shape[:3]
    dev = rows.device
    pos = starts.long()[:, None, None] + torch.arange(T, device=dev)
    b = torch.arange(B, device=dev)[:, None, None]
    h = torch.arange(Hkv, device=dev)[None, :, None]
    plane[b, h, pos] = rows.to(plane.dtype)


def _cache_prefill_attn(cfg, q, k, v, cache, l, starts):
    """The prefill over an existing cache: k/v (B, Hkv, T, hd) written at
    ``starts`` (quantized with their scales under an int8 cache), then q
    attends layer l's whole cache, dequantized, under ``make_chunk_mask``."""
    quant = "k_s" in cache
    for name, new in (("k", k), ("v", v)):
        if quant:
            rows, scales = quantize_kv(new)
            _write_rows(cache[name + "_s"][l], scales, starts)
        else:
            rows = new
        _write_rows(cache[name][l], rows, starts)
    ck, cv = cache["k"][l], cache["v"][l]
    if quant:
        ck = ck.to(q.dtype) * cache["k_s"][l][..., None].to(q.dtype)
        cv = cv.to(q.dtype) * cache["v_s"][l][..., None].to(q.dtype)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    mask = make_chunk_mask(starts, q.shape[2], ck.shape[2])
    return dot_product_attention(q, repeat_kv(ck.to(q.dtype), n_rep),
                                 repeat_kv(cv.to(q.dtype), n_rep), mask)


def _layer_forward(cfg, layer, lo, lora_scaling, x, positions, inv_freq, lengths,
                   cache=None, l=0, starts=None, lora_ids=None, attn=None):
    B, T, _ = x.shape
    layer, lo = _gathered(layer, lo, bank=lora_ids is not None)
    q, k, v = _qkv_heads(cfg, layer, lo, lora_scaling, x, positions, inv_freq, lora_ids)
    if attn is not None:  # ring or sequence-parallel attention (cacheless)
        out = attn(q, k.to(q.dtype), v.to(q.dtype), l)
    elif starts is not None:
        out = _cache_prefill_attn(cfg, q, k, v, cache, l, starts)
    else:
        if cache is not None:
            if "k_s" in cache:  # int8 cache: quantized rows and their scales at [0, T)
                (cache["k"][l, :, :, :T], cache["k_s"][l, :, :, :T]) = quantize_kv(k)
                (cache["v"][l, :, :, :T], cache["v_s"][l, :, :, :T]) = quantize_kv(v)
            else:
                cache["k"][l, :, :, :T] = k
                cache["v"][l, :, :, :T] = v
        # attention over the current k/v, unquantized under an int8 cache
        out = flash_attention(q, k.to(q.dtype), v.to(q.dtype), lengths, causal=True)
    out = out.transpose(1, 2).reshape(B, T, cfg.n_heads * cfg.hd)
    return _attn_out_mlp(cfg, layer, lo, lora_scaling, x, out, lora_ids)


def run_layer_stack(cfg: DecoderConfig, layers: Dict[str, Any], x: torch.Tensor,
                    positions: torch.Tensor, lengths: Optional[torch.Tensor],
                    lora: Optional[Dict[str, Any]] = None, lora_scaling: float = 1.0,
                    remat=False, attn=None, cache: Optional[Dict[str, torch.Tensor]] = None,
                    cache_positions: Optional[torch.Tensor] = None,
                    lora_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run a contiguous sub-stack of decoder layers (leading dim of
    ``layers`` and ``lora``), no final norm: the loop ``decoder_forward``
    runs over every layer and a pipeline stage over its own
    (``parallel/pipeline.py``), as the JAX package's ``run_layer_stack``.
    ``attn`` (q, k, v heads-first, layer → out) replaces the causal flash
    attention of a cacheless stack (ring and sequence-parallel attention);
    ``remat`` as ``decoder_forward``'s, its "1inK" over this stack."""
    n = layers["ln_attn"].shape[0]
    inv_freq = _inv_freq(cfg, x.device)
    g = _mixed_remat_group(remat)
    if g and n % g:
        _warn_remat_degraded(remat, n, "stack not divisible by K")
        g, remat = 0, True
    plain = functools.partial(_layer_forward, cfg, attn=attn)
    ckpt = _checkpointed(True if g else remat, plain) if remat else None
    sh = current_shard()
    keep = sh.keep_shards if sh is not None else contextlib.nullcontext
    for l in range(n):
        layer = layer_at(layers, l)
        lo = layer_at(lora, l) if lora is not None else None
        args = (layer, lo, lora_scaling, x, positions, inv_freq, lengths, cache, l,
                cache_positions, lora_ids)
        if ckpt is not None and not (g and l % g == g - 1):
            x = ckpt(*args)
        else:  # the backward keeps the FSDP shards of the layer's weights only
            with keep():
                x = plain(*args)
    return x


def decoder_forward(cfg: DecoderConfig, params: Dict[str, Any], inputs_embeds: torch.Tensor,
                    lengths: torch.Tensor, cache: Optional[Dict[str, torch.Tensor]] = None,
                    lora: Optional[Dict[str, Any]] = None, lora_scaling: float = 1.0,
                    remat=False, lora_ids: Optional[torch.Tensor] = None,
                    cache_positions: Optional[torch.Tensor] = None, ring=None,
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Causal prefill over right-padded prompts: inputs_embeds (B, T, dim),
    lengths (B,) valid positions. Writes every layer's k/v into cache[..., :T, :]
    in place when a cache is given. Returns (final-normed hidden, cache).
    ``lora_ids`` (B,): ``lora`` is a ``stack_lora_bank`` bank, sample b
    applies adapter lora_ids[b].

    ``cache_positions`` (B,) int (needs a cache; ``lengths`` is unused):
    the prefill over an existing cache. Sample b's tokens sit at RoPE
    positions cache_positions[b] + i, their k/v are written there, and they
    attend every cache position up to their own (``_cache_prefill_attn``).

    ``ring=(mesh, axis)`` (no cache): every layer's attention is
    ``parallel/ring_attention.py:ring_attention`` over the mesh axis, each
    rank holding the whole input and its sequence shard of k/v, as the
    JAX package's ``ring``.

    ``remat`` (training): ``True`` checkpoints every layer,
    ``"dots"`` every layer with the weight-matmul outputs saved, ``"1inK"``
    checkpoints K−1 of every K layers and runs the K-th plain (a K that does
    not divide ``n_layers`` degrades to full remat, with a warning)."""
    B, T, _ = inputs_embeds.shape
    cfg = _local_cfg(cfg)
    positions = torch.arange(T, device=inputs_embeds.device)[None].expand(B, T)
    if cache_positions is not None:
        if cache is None:
            raise ValueError("cache_positions needs a cache")
        positions = cache_positions.long()[:, None] + positions
    attn = None
    if ring is not None and cache is None:
        from ..parallel.ring_attention import ring_attention

        mesh, axis = ring

        def attn(q, k, v, layer):
            return ring_attention(q, k, v, mesh, axis_name=axis, lengths=lengths, causal=True,
                                  layer=layer)

    x = run_layer_stack(cfg, params["layers"], inputs_embeds, positions, lengths, lora,
                        lora_scaling, remat, attn, cache=cache, cache_positions=cache_positions,
                        lora_ids=lora_ids)
    return rms_norm(x, params["final_norm"], cfg.rms_eps), cache


def _xla_decode_attn(cfg: DecoderConfig, q, ck, cv, k_self, v_self, lengths,
                     k_s=None, v_s=None):
    """Single-token decode attention over one layer's cache slice.

    q (B, H, 1, hd); ck/cv (B, Hkv, S, hd), read-only; the current token's
    (k_self, v_self) (B, Hkv, 1, hd) is one extra softmax column, never
    quantized; cache positions ≥ lengths[b] are masked. An int8 cache comes
    with its scales k_s/v_s (B, Hkv, S): k's fold into the scores after the
    product, v's into the probabilities. GQA by grouped matmuls, no repeat."""
    B, H, _, hd = q.shape
    Hkv, S = ck.shape[1], ck.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g, hd).float()
    sm = hd ** -0.5
    s_cache = torch.matmul(qg, ck.float().transpose(-1, -2)) * sm  # (B, Hkv, g, S)
    if k_s is not None:
        s_cache = s_cache * k_s[:, :, None, :]
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s_cache = s_cache.masked_fill(~valid[:, None, None, :], float("-inf"))
    s_self = torch.matmul(qg, k_self.reshape(B, Hkv, hd, 1).float()) * sm  # (B, Hkv, g, 1)
    m = torch.maximum(s_cache.amax(dim=-1, keepdim=True), s_self)
    p_cache = torch.exp(s_cache - m)
    p_self = torch.exp(s_self - m)
    l = p_cache.sum(dim=-1, keepdim=True) + p_self
    if v_s is not None:
        p_cache = p_cache * v_s[:, :, None, :]
    out = torch.matmul(p_cache.to(q.dtype), cv.to(q.dtype)).float()
    out = out + p_self * v_self.reshape(B, Hkv, 1, hd).float()
    return (out / l).reshape(B, H, 1, hd).to(q.dtype)


class DecodeAttention(enum.Enum):
    """The decode step's attention, the JAX package's tri-state
    ``use_flash_decode`` as an enum: ``XLA`` is ``_xla_decode_attn`` (JAX's
    ``"xla"``, the default), ``FLASH`` the K7 flash-decode kernel (JAX's
    ``True``), ``GENERIC`` JAX's scanned-layer path (``False``): each layer
    writes its row into the cache first, then attends the cache with the
    plain masked math."""

    XLA = "xla"
    FLASH = "flash"
    GENERIC = "generic"

    @classmethod
    def of(cls, value) -> "DecodeAttention":
        """A member, or JAX's value for it: ``"xla"``, ``True``, ``False``."""
        if isinstance(value, cls):
            return value
        if value is True:
            return cls.FLASH
        if value is False:
            return cls.GENERIC
        if value == "xla":
            return cls.XLA
        raise ValueError(f"use_flash_decode must be 'xla', True or False, got {value!r}")


def decode_step(cfg: DecoderConfig, params: Dict[str, Any], x: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_positions: torch.Tensor,
                lora: Optional[Dict[str, Any]] = None, lora_scaling: float = 1.0,
                attention: DecodeAttention = DecodeAttention.XLA,
                lora_ids: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One cached decode step: x (B, 1, dim) at positions cache_positions (B,)
    int32 (each sample's count of cached tokens). Every layer attends its
    cache slice read-only plus the current token (``attention``: the plain
    ``_xla_decode_attn``, or the K7 kernel over the stacked cache where
    ``flash_decode_usable`` admits the shapes, as JAX routes, and for the
    int8 cache where K7 q8 can read its layout, ``q8_cache_layout_ok``);
    after the loop ONE append writes all layers' new k/v at cache_positions,
    in place: ``append_kv`` for a bf16 cache, ``append_kv_q8`` for an int8
    one, which quantizes the rows and writes their scales in the same launch
    (the JAX package quantizes in its scan and writes the scales with a
    per-sample DUS). ``lora_ids`` (B,): ``lora`` is a bank, as in
    ``decoder_forward``. ``GENERIC`` appends each layer's rows before its
    attention instead (``_generic_decode_attn``)."""
    cfg = _local_cfg(cfg)
    B = x.shape[0]
    L, hd = cfg.n_layers, cfg.hd
    quant = "k_s" in cache
    generic = attention is DecodeAttention.GENERIC
    # split heads under a mesh: JAX's flash gate is false, its plain math runs
    split = isinstance(cfg, SplitHeadConfig)
    flash = attention is DecodeAttention.FLASH and not split and flash_decode_usable(
        (B, cfg.n_heads, 1, hd), (B, cfg.n_kv_heads) + tuple(cache["k"].shape[-2:])) and (
        not quant or q8_cache_layout_ok(cache["k"], cache["v"], cache["k_s"], cache["v_s"]))
    inv_freq = _inv_freq(cfg, x.device)
    positions = cache_positions[:, None]
    # the new rows: the cache's dtype, or the activations' (k's) for the int8
    # cache, which the append quantizes
    new_k = torch.empty((L, B, cfg.n_kv_heads, 1, hd),
                        dtype=x.dtype if quant else cache["k"].dtype, device=x.device)
    new_v = torch.empty_like(new_k)
    scales = (cache["k_s"], cache["v_s"]) if quant else ()
    for l in range(L):
        layer, lo = _gathered(layer_at(params["layers"], l),
                              layer_at(lora, l) if lora is not None else None,
                              bank=lora_ids is not None)
        q, k, v = _qkv_heads(cfg, layer, lo, lora_scaling, x, positions, inv_freq, lora_ids)
        if generic:
            out = _generic_decode_attn(cfg, q, k, v, cache, l, cache_positions)
        elif flash and quant:
            out = flash_decode_attention_q8(q, cache["k"], cache["v"], *scales, cache_positions,
                                            self_kv=(k, v), layer=l)
        elif flash:
            out = flash_decode_attention(q, cache["k"], cache["v"], cache_positions,
                                         self_kv=(k, v), layer=l)
        else:
            out = _xla_decode_attn(cfg, q, cache["k"][l], cache["v"][l], k, v, cache_positions,
                                   *(s[l] for s in scales))
        new_k[l] = k
        new_v[l] = v
        x = _attn_out_mlp(cfg, layer, lo, lora_scaling, x,
                          out.transpose(1, 2).reshape(B, 1, cfg.n_heads * hd), lora_ids)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if generic:  # every layer appended its own rows
        return x, cache
    if quant:
        append_kv_q8(cache["k"], cache["v"], *scales, new_k, new_v, cache_positions)
    else:
        append_kv(cache["k"], cache["v"], new_k, new_v, cache_positions)
    return x, cache


def _generic_decode_attn(cfg: DecoderConfig, q, k, v, cache, l: int, positions):
    """JAX's scanned-layer decode attention for layer l: the new rows k/v
    (B, Hkv, 1, hd) written into the cache at ``positions`` first (K4 on the
    layer's slice, or K4 q8, which quantizes them with their scales), then
    q attends the (dequantized) cache up to and including its own position
    under ``make_decode_mask`` with the plain masked attention."""
    one = slice(l, l + 1)
    if "k_s" in cache:
        append_kv_q8(cache["k"][one], cache["v"][one], cache["k_s"][one], cache["v_s"][one],
                     k[None].contiguous(), v[None].contiguous(), positions)
        ck = cache["k"][l].to(q.dtype) * cache["k_s"][l][..., None].to(q.dtype)
        cv = cache["v"][l].to(q.dtype) * cache["v_s"][l][..., None].to(q.dtype)
    else:
        dt = cache["k"].dtype
        append_kv(cache["k"][one], cache["v"][one], k.to(dt)[None].contiguous(),
                  v.to(dt)[None].contiguous(), positions)
        ck, cv = cache["k"][l].to(q.dtype), cache["v"][l].to(q.dtype)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    mask = make_decode_mask(positions + 1, ck.shape[2])
    return dot_product_attention(q, repeat_kv(ck, n_rep), repeat_kv(cv, n_rep), mask)


def embed_tokens(params: Dict[str, Any], token_ids: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Token ids → embeddings. Ids past the table clamp to its last row, as
    the JAX package's gather does (the in-repo tokenizer's vocabulary is
    larger than Vicuna's 32000). Under tensor parallelism the table is the
    rank's block of rows: ids clamp to the whole table's last row first,
    each rank looks up the ids it holds (zeros elsewhere) and the blocks
    are summed over tp."""
    table = params["tok_embed"]
    sh = current_shard()
    if sh is None or sh.tp == 1:
        return table[token_ids.clamp(max=table.shape[0] - 1)].to(dtype)
    n = table.shape[0]
    local = token_ids.long().clamp(max=n * sh.tp - 1) - sh.tp_rank * n
    held = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].to(dtype) * held[..., None].to(dtype)
    return sh.reduce_from_tp(rows)


def lm_logits(cfg: DecoderConfig, params: Dict[str, Any], hidden: torch.Tensor,
              gather: bool = True) -> torch.Tensor:
    """hidden (…, dim) → logits (…, V). Under tensor parallelism each rank
    computes its vocabulary block (the tied ``tok_embed.T`` or
    ``lm_head``'s columns), gathered whole unless ``gather`` is False (the
    vocab-parallel loss); a quantized lm_head is whole on every rank."""
    w = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    sh = current_shard()
    if sh is None or sh.tp == 1:
        return dequant_matmul(hidden, w)
    if isinstance(w, dict):
        logits = dequant_matmul(hidden, w)
        return logits if gather else logits[..., sh.cols(logits.shape[-1])]
    local = dequant_matmul(sh.copy_to_tp(hidden), w)
    return sh.gather_tp(local, -1) if gather else local


def decoder_loss(cfg: DecoderConfig, params: Dict[str, Any], hidden: torch.Tensor,
                 labels: torch.Tensor, ignore_index: int = -100) -> torch.Tensor:
    """The LM head and ``cross_entropy_loss``; under tensor parallelism over
    vocab-sharded logits (``vocab_parallel_cross_entropy``)."""
    sh = current_shard()
    if sh is None or sh.tp == 1:
        return cross_entropy_loss(lm_logits(cfg, params, hidden), labels, ignore_index)
    return vocab_parallel_cross_entropy(lm_logits(cfg, params, hidden, gather=False), labels,
                                        sh, ignore_index)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, sh,
                                 ignore_index: int = -100) -> torch.Tensor:
    """``cross_entropy_loss`` over this tp rank's vocabulary block of the
    logits (…, V/tp): the max over tp, the softmax denominator and the
    label's logit summed over tp, all in f32. The rank holding no label
    contributes 0; a label past the whole vocabulary still gives a NaN loss
    (the train step then skips the batch everywhere), and the denominator
    is max(count, 1), as ``cross_entropy_loss``."""
    mask = labels != ignore_index
    n = logits.shape[-1]
    V = n * sh.tp
    lf = logits.float()
    m = sh.max_over_tp(lf.detach().amax(dim=-1))
    sumexp = sh.reduce_from_tp(torch.exp(lf - m[..., None]).sum(dim=-1))
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long().clamp(0, V - 1)
    local = safe - sh.tp_rank * n
    held = (local >= 0) & (local < n)
    picked = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    target = sh.reduce_from_tp(torch.where(held, picked, torch.zeros_like(picked)))
    nll = torch.log(sumexp) + m - target
    nll = torch.where(mask & (labels >= V), torch.full_like(nll, float("nan")), nll)
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Mean CE over positions where labels != ignore_index, in f32; labels are
    pre-shifted (next-token targets aligned to logits). The denominator is
    max(count, 1). A label past the vocabulary gives a NaN loss, as the JAX
    package's fill-mode gather does (the train step then skips the batch)."""
    mask = labels != ignore_index
    V = logits.shape[-1]
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long().clamp(0, V - 1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(mask & (labels >= V), torch.full_like(nll, float("nan")), nll)
    return (nll * mask).sum() / mask.sum().clamp(min=1)
