"""Synthetic reference-layout checkpoints for pipeline validation.

Counterpart of ``icl_speech_text_llm_tpu/models/synth_ckpt.py``, with the same
tensors from the same seed; the HF shards are written by the port's numpy
safetensors writer (``utils/safetensors_np.py``), so no ``safetensors``
package is needed.

The real ``salmonn_v1.pth`` / Vicuna HF shards cannot ship with the repo;
these generators write checkpoints with EXACTLY the reference key layout at
any scale, so the full convert → load → generate pipeline is testable end to
end at real 13B shapes without the real weights. Layout ground truth:

- ``salmonn_v1.pth``: the external SALMONN package's trainable state dict
  (the reference points its config "ckpt" at it — ref:
  models/custom_salmon.py:83; PEFT LoRA key nesting trap at :190-192).
  Wrapped as ``{"model": {...}}`` with keys: ``speech_query_tokens``,
  ``ln_speech.*`` / ``ln_audio.*``, ``speech_Qformer.bert.encoder.layer.N.*``
  (BERT self+cross attention, query-branch FFN — plus the unused text-branch
  FFN keys a real BLIP-2 Q-Former carries, which converters must skip),
  ``speech_llama_proj.*``, and PEFT LoRA tensors
  ``llama_model.base_model.model.model.layers.N.self_attn.{q,v}_proj.lora_{A,B}[.default].weight``.
- HF decoder dirs: sharded safetensors + ``model.safetensors.index.json``.

Values are synthetic (tiled random blocks — cheap to generate at 26 GB scale);
only the layout, shapes, and dtypes matter.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from ..utils.safetensors_np import save_file
from .llama import DecoderConfig
from .qformer import QFormerConfig


def _filler(rng: np.random.RandomState, shape, dtype=np.float32) -> np.ndarray:
    """Random-looking tensor in O(64KB) of RNG work: tile one random block."""
    n = int(np.prod(shape))
    block = rng.standard_normal(min(n, 16384)).astype(dtype) * 0.02
    return np.resize(block, shape)


def salmonn_v1_state_dict(
    qf: QFormerConfig,
    llm: DecoderConfig,
    whisper_dim: int,
    beats_dim: int,
    rank: int = 8,
    seed: int = 0,
    peft_default: bool = False,
) -> Dict[str, np.ndarray]:
    """Full-layout SALMONN trainable state dict (torch key names/shapes).

    ``peft_default=True`` emits the newer PEFT naming
    (``lora_A.default.weight``); both spellings occur in the wild and the
    converter accepts either.
    """
    if whisper_dim + beats_dim != qf.encoder_width:
        raise ValueError(f"whisper_dim {whisper_dim} + beats_dim {beats_dim} != the Q-Former's "
                         f"encoder_width {qf.encoder_width}")
    rng = np.random.RandomState(seed)
    d, ew, inner = qf.dim, qf.encoder_width, qf.mlp_ratio * qf.dim
    sd: Dict[str, np.ndarray] = {
        "speech_query_tokens": _filler(rng, (1, qf.n_query, d)),
        "ln_speech.weight": np.ones(whisper_dim, np.float32),
        "ln_speech.bias": np.zeros(whisper_dim, np.float32),
        "ln_audio.weight": np.ones(beats_dim, np.float32),
        "ln_audio.bias": np.zeros(beats_dim, np.float32),
        "speech_llama_proj.weight": _filler(rng, (qf.llm_dim, d)),
        "speech_llama_proj.bias": np.zeros(qf.llm_dim, np.float32),
    }
    for i in range(qf.n_layers):
        p = f"speech_Qformer.bert.encoder.layer.{i}."
        for branch, kv_dim in (("attention", d), ("crossattention", ew)):
            sd[p + f"{branch}.self.query.weight"] = _filler(rng, (d, d))
            sd[p + f"{branch}.self.query.bias"] = np.zeros(d, np.float32)
            sd[p + f"{branch}.self.key.weight"] = _filler(rng, (d, kv_dim))
            sd[p + f"{branch}.self.key.bias"] = np.zeros(d, np.float32)
            sd[p + f"{branch}.self.value.weight"] = _filler(rng, (d, kv_dim))
            sd[p + f"{branch}.self.value.bias"] = np.zeros(d, np.float32)
            sd[p + f"{branch}.output.dense.weight"] = _filler(rng, (d, d))
            sd[p + f"{branch}.output.dense.bias"] = np.zeros(d, np.float32)
            sd[p + f"{branch}.output.LayerNorm.weight"] = np.ones(d, np.float32)
            sd[p + f"{branch}.output.LayerNorm.bias"] = np.zeros(d, np.float32)
        # query-branch FFN (the one the speech Q-Former uses)
        sd[p + "intermediate_query.dense.weight"] = _filler(rng, (inner, d))
        sd[p + "intermediate_query.dense.bias"] = np.zeros(inner, np.float32)
        sd[p + "output_query.dense.weight"] = _filler(rng, (d, inner))
        sd[p + "output_query.dense.bias"] = np.zeros(d, np.float32)
        sd[p + "output_query.LayerNorm.weight"] = np.ones(d, np.float32)
        sd[p + "output_query.LayerNorm.bias"] = np.zeros(d, np.float32)
        # unused text-branch FFN keys (present in real BLIP-2 Q-Formers)
        sd[p + "intermediate.dense.weight"] = _filler(rng, (inner, d))
        sd[p + "intermediate.dense.bias"] = np.zeros(inner, np.float32)
        sd[p + "output.dense.weight"] = _filler(rng, (d, inner))
        sd[p + "output.dense.bias"] = np.zeros(d, np.float32)
        sd[p + "output.LayerNorm.weight"] = np.ones(d, np.float32)
        sd[p + "output.LayerNorm.bias"] = np.zeros(d, np.float32)
    infix = "default." if peft_default else ""
    for i in range(llm.n_layers):
        base = f"llama_model.base_model.model.model.layers.{i}.self_attn."
        sd[base + f"q_proj.lora_A.{infix}weight"] = _filler(rng, (rank, llm.dim))
        sd[base + f"q_proj.lora_B.{infix}weight"] = _filler(rng, (llm.n_heads * llm.hd, rank))
        sd[base + f"v_proj.lora_A.{infix}weight"] = _filler(rng, (rank, llm.dim))
        sd[base + f"v_proj.lora_B.{infix}weight"] = _filler(rng, (llm.n_kv_heads * llm.hd, rank))
    return sd


def write_salmonn_v1(
    path: str,
    qf: QFormerConfig,
    llm: DecoderConfig,
    whisper_dim: int,
    beats_dim: int,
    rank: int = 8,
    seed: int = 0,
    peft_default: bool = False,
    wrapper: str = "model",
) -> int:
    """torch.save a full-layout salmonn_v1.pth (``{"model": sd}`` wrapper by
    default, as the official SALMONN release stores it; pass another
    ``wrapper`` to exercise the loader's other fallback keys, or "" for a
    bare state dict). Returns the tensor count."""
    import torch

    sd = {k: torch.from_numpy(v) for k, v in salmonn_v1_state_dict(
        qf, llm, whisper_dim, beats_dim,
        rank=rank, seed=seed, peft_default=peft_default).items()}
    torch.save({wrapper: sd} if wrapper else sd, path)
    return len(sd)


def write_hf_decoder_shards(
    path: str,
    cfg: DecoderConfig,
    dtype=np.float16,
    seed: int = 0,
    shard_bytes: int = 4 << 30,
    tie_lm_head: Optional[bool] = None,
) -> int:
    """HF-layout sharded safetensors decoder checkpoint + index.json.

    Tensors are generated one at a time and flushed per shard, so a 26 GB
    fp16 13B checkpoint writes with bounded memory. Returns total bytes."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(seed)
    hd = cfg.hd
    tie = cfg.tie_embeddings if tie_lm_head is None else tie_lm_head

    def tensors():
        yield "model.embed_tokens.weight", (cfg.vocab_size, cfg.dim)
        for i in range(cfg.n_layers):
            p = f"model.layers.{i}."
            yield p + "self_attn.q_proj.weight", (cfg.n_heads * hd, cfg.dim)
            yield p + "self_attn.k_proj.weight", (cfg.n_kv_heads * hd, cfg.dim)
            yield p + "self_attn.v_proj.weight", (cfg.n_kv_heads * hd, cfg.dim)
            yield p + "self_attn.o_proj.weight", (cfg.dim, cfg.n_heads * hd)
            if cfg.qkv_bias:
                yield p + "self_attn.q_proj.bias", (cfg.n_heads * hd,)
                yield p + "self_attn.k_proj.bias", (cfg.n_kv_heads * hd,)
                yield p + "self_attn.v_proj.bias", (cfg.n_kv_heads * hd,)
            yield p + "mlp.gate_proj.weight", (cfg.hidden_dim, cfg.dim)
            yield p + "mlp.up_proj.weight", (cfg.hidden_dim, cfg.dim)
            yield p + "mlp.down_proj.weight", (cfg.dim, cfg.hidden_dim)
            yield p + "input_layernorm.weight", (cfg.dim,)
            yield p + "post_attention_layernorm.weight", (cfg.dim,)
        yield "model.norm.weight", (cfg.dim,)
        if not tie:
            yield "lm_head.weight", (cfg.vocab_size, cfg.dim)

    weight_map: Dict[str, str] = {}
    shard: Dict[str, np.ndarray] = {}
    shard_size = 0
    total = 0
    shard_idx = 0

    def flush():
        nonlocal shard, shard_size, shard_idx
        if not shard:
            return
        fn = f"model-{shard_idx:05d}.safetensors"
        save_file(shard, os.path.join(path, fn))
        for k in shard:
            weight_map[k] = fn
        shard = {}
        shard_size = 0
        shard_idx += 1

    for name, shape in tensors():
        arr = _filler(rng, shape, np.dtype(dtype))
        if name.endswith("layernorm.weight") or name == "model.norm.weight":
            arr = np.ones(shape, dtype)
        shard[name] = arr
        shard_size += arr.nbytes
        total += arr.nbytes
        if shard_size >= shard_bytes:
            flush()
    flush()
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    return total
