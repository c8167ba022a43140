"""Symbol-adapter loss: the SALMONN training forward with the MLP label
transform applied to the text embeddings.

Counterpart of ``icl_speech_text_llm_tpu/symbol_adapter/losses.py`` (ref:
models/mlp_salmonn_old.py:338-430: compute_mlp_loss /
compute_standard_loss): ``models/salmonn.py:salmonn_train_loss`` with
``transform_label_embeddings`` applied to the text-token embeddings before
the sequence gather. Only LoRA and the MLP adapter train here, so the mel
frontend, the frozen encoders and the Q-Former run under
``torch.no_grad()``; the decoder takes the kernel path of
``salmonn_train_loss`` (K1 forward, K5/K6 backward through
``FlashAttention`` on the card), also in an MLP-only phase, where the
gradient reaches the text embeddings through every layer.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models.llama import cross_entropy_loss, decoder_forward, embed_tokens, lm_logits
from ..models.salmonn import SalmonnConfig, encode_speech, gather_sequence
from ..ops.mel import log_mel_spectrogram, pad_or_trim, wavs_to_float
from .mlp_adapter import transform_label_embeddings


def mlp_salmonn_train_loss(
    cfg: SalmonnConfig,
    params: Dict[str, Any],
    batch: Dict[str, torch.Tensor],
    mlp_params: Optional[Dict[str, Any]] = None,
    temperature: float = 0.1,
    hard_quantization: bool = False,
    bypass_mlp: bool = False,
    lora_params: Optional[Dict[str, Any]] = None,
    remat=False,
):
    """Packed batch (+ label_mask) → (loss, discovered_ids, similarities).

    ``batch`` (tensors on the model's device) adds ``label_mask`` (B,
    L_text) bool over the symbol-token positions of ``text_tokens``.
    ``lora_params`` replaces ``params["lora"]`` (the trainer's masters)."""
    B = batch["text_tokens"].shape[0]
    dt = cfg.compute_dtype
    with torch.no_grad():
        wavs = wavs_to_float(batch["wavs"])
        n_slots = wavs.shape[1]
        flat = pad_or_trim(wavs.reshape(B * n_slots, wavs.shape[-1]))  # 30 s for the encoders
        speech = encode_speech(cfg, params, log_mel_spectrogram(flat),
                               flat if cfg.beats is not None else None)
    speech = speech.reshape(B, n_slots, -1, cfg.llm.dim)

    text_embeds = embed_tokens(params["llm"], batch["text_tokens"], dtype=dt)
    shape = batch["text_tokens"].shape
    if mlp_params is not None:
        text_embeds, disc_ids, sims = transform_label_embeddings(
            mlp_params, text_embeds, batch["label_mask"], params["llm"]["tok_embed"],
            temperature=temperature, hard=hard_quantization, bypass=bypass_mlp)
    else:
        disc_ids = torch.full(shape, -1, dtype=torch.int32, device=text_embeds.device)
        sims = torch.zeros(shape, dtype=dt, device=text_embeds.device)

    seq = gather_sequence(text_embeds, speech, batch["gather_idx"])
    lengths = batch["seq_mask"].sum(dim=1).to(torch.int32)
    lora = lora_params if lora_params is not None else params.get("lora")
    scaling = cfg.lora.scaling if cfg.lora is not None else 1.0
    hidden, _ = decoder_forward(cfg.llm, params["llm"], seq, lengths, lora=lora,
                                lora_scaling=scaling, remat=remat)
    loss = cross_entropy_loss(lm_logits(cfg.llm, params["llm"], hidden), batch["shifted_labels"])
    return loss, disc_ids, sims
