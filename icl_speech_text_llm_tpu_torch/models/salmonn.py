"""SALMONN in PyTorch: Whisper + BEATs → window-level Q-Former → LLM (+LoRA).

Counterpart of ``icl_speech_text_llm_tpu/models/salmonn.py`` for inference:
the configs, ``init_salmonn``, ``encode_speech`` (every clip of the batch —
query and exemplars — through the encoders in one call) and
``assemble_sequence`` (one gather over [pad | text | speech] embeddings).
Generation is in ``inference/engine.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .beats import BEATS_CONFIGS, BeatsConfig, beats_bias_table, beats_encode, beats_num_tokens, init_beats
from .llama import DECODER_CONFIGS, DecoderConfig, LoraConfig, embed_tokens, init_decoder, init_lora
from .qformer import QFORMER_CONFIGS, QFormerConfig, init_qformer, qformer_windows
from .whisper import WHISPER_CONFIGS, WhisperEncoderConfig, init_whisper_encoder, whisper_encode


@dataclass(frozen=True)
class SalmonnConfig:
    whisper: WhisperEncoderConfig
    qformer: QFormerConfig
    llm: DecoderConfig
    beats: Optional[BeatsConfig] = None  # None → whisper-only encoder stack
    lora: Optional[LoraConfig] = LoraConfig()
    compute_dtype: Any = torch.float32

    @property
    def audio_tokens_per_slot(self) -> int:
        return self.qformer.n_windows * self.qformer.n_query


def salmonn_13b() -> SalmonnConfig:
    return SalmonnConfig(
        whisper=WHISPER_CONFIGS["large-v2"], beats=BEATS_CONFIGS["iter3-as2m"],
        qformer=QFORMER_CONFIGS["salmonn"], llm=DECODER_CONFIGS["vicuna-13b"],
        lora=LoraConfig(rank=8, alpha=32.0, targets=("wq", "wv")),
        compute_dtype=torch.bfloat16)


def salmonn_7b() -> SalmonnConfig:
    return SalmonnConfig(
        whisper=WHISPER_CONFIGS["large-v2"], beats=BEATS_CONFIGS["iter3-as2m"],
        qformer=QFORMER_CONFIGS["salmonn-7b"], llm=DECODER_CONFIGS["vicuna-7b"],
        lora=LoraConfig(rank=8, alpha=32.0, targets=("wq", "wv")),
        compute_dtype=torch.bfloat16)


def salmonn_bench() -> SalmonnConfig:
    """The JAX package's fixed benchmark config: full topology, head_dim-128
    LLM, bf16."""
    return SalmonnConfig(
        whisper=WhisperEncoderConfig(dim=512, n_heads=8, n_layers=8),
        beats=BeatsConfig(dim=256, embed_dim=128, n_heads=4, n_layers=4, conv_pos=64,
                          conv_pos_groups=8),
        qformer=QFormerConfig(encoder_width=512 + 256, dim=256, n_heads=4, n_layers=2,
                              llm_dim=1024),
        llm=DECODER_CONFIGS["bench"],
        lora=LoraConfig(rank=8, alpha=32.0, targets=("wq", "wv")),
        compute_dtype=torch.bfloat16)


def salmonn_tiny() -> SalmonnConfig:
    """CPU-testable config with the full component topology."""
    qf = QFORMER_CONFIGS["tiny-test"]
    return SalmonnConfig(
        whisper=WHISPER_CONFIGS["tiny-test"], beats=BEATS_CONFIGS["tiny-test"],
        qformer=QFormerConfig(encoder_width=64 + 64, dim=qf.dim, n_heads=qf.n_heads,
                              n_layers=qf.n_layers, llm_dim=DECODER_CONFIGS["tiny"].dim),
        llm=DECODER_CONFIGS["tiny"],
        lora=LoraConfig(rank=4, alpha=8.0, targets=("wq", "wv")))


def init_salmonn(cfg: SalmonnConfig, gen: torch.Generator, device,
                 dtype=torch.float32) -> Dict[str, Any]:
    """Random-init parameter tree with the JAX package's layout, drawn from
    ``gen`` on ``device`` and stored in ``dtype``."""
    params = {
        "whisper": init_whisper_encoder(cfg.whisper, gen, device, dtype),
        "qformer": init_qformer(cfg.qformer, gen, device, dtype),
        "llm": init_decoder(cfg.llm, gen, device, dtype),
    }
    if cfg.beats is not None:
        params["beats"] = init_beats(cfg.beats, gen, device, dtype)
    if cfg.lora is not None:
        params["lora"] = init_lora(cfg.llm, cfg.lora, gen, device, dtype)
    return params


def encode_speech(cfg: SalmonnConfig, params: Dict[str, Any], mels: torch.Tensor,
                  wavs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All clips at once: mels (N, 80, 3000) [+ wavs (N, n) for BEATs] →
    (N, T_a, llm_dim)."""
    dt = cfg.compute_dtype
    feats = whisper_encode(cfg.whisper, params["whisper"], mels, dtype=dt)
    if cfg.beats is not None and wavs is not None:
        bias = None
        if cfg.beats.gated_rel_pos:
            nt = beats_num_tokens(cfg.beats, wavs.shape[-1])
            bias = beats_bias_table(cfg.beats, params["beats"], nt)
        audio = beats_encode(cfg.beats, params["beats"], wavs, dtype=dt, bias_table=bias)
        audio = F.pad(audio, (0, 0, 0, feats.shape[1] - audio.shape[1]))
        feats = torch.cat([feats, audio], dim=-1)
    return qformer_windows(cfg.qformer, params["qformer"], feats)


def assemble_sequence(cfg: SalmonnConfig, params: Dict[str, Any], text_tokens: torch.Tensor,
                      speech_embeds: torch.Tensor, gather_idx: torch.Tensor) -> torch.Tensor:
    """One gather builds the interleaved text/speech sequence (B, L_seq, D):
    index 0 is padding, then the text embeddings, then the flattened clips."""
    dt = cfg.compute_dtype
    B = text_tokens.shape[0]
    text_embeds = embed_tokens(params["llm"], text_tokens, dtype=dt)
    D = text_embeds.shape[-1]
    table = torch.cat([torch.zeros((B, 1, D), dtype=dt, device=text_embeds.device),
                       text_embeds, speech_embeds.reshape(B, -1, D).to(dt)], dim=1)
    idx = gather_idx.long()[..., None].expand(-1, -1, D)
    return torch.gather(table, 1, idx)
