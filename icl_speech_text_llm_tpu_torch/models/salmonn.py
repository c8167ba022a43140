"""SALMONN in PyTorch: Whisper + BEATs → window-level Q-Former → LLM (+LoRA).

Counterpart of ``icl_speech_text_llm_tpu/models/salmonn.py``: the configs,
``init_salmonn``, ``encode_speech`` (every clip of the batch — query and
exemplars — through the encoders in one call, or in sequential chunks of
``encode_chunk`` clips), ``assemble_sequence`` (one gather over [pad | text |
speech] embeddings) and ``salmonn_train_loss``.
Generation is in ``inference/engine.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.mel import log_mel_spectrogram, pad_or_trim, wavs_to_float
from .beats import BEATS_CONFIGS, BeatsConfig, beats_bias_table, beats_encode, beats_num_tokens, init_beats
from .llama import (
    DECODER_CONFIGS,
    DecoderConfig,
    LoraConfig,
    cross_entropy_loss,
    decoder_forward,
    embed_tokens,
    init_decoder,
    init_lora,
    lm_logits,
)
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
    # >0: run the encoders and the Q-Former over the clips in sequential
    # chunks of this size (when it divides their number), bounding their peak
    # activation memory
    encode_chunk: int = 0

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


#: the subtrees that train (LoRA and the Q-Former); everything else is frozen
TRAINABLE_KEYS = ("lora", "qformer")


def init_salmonn(cfg: SalmonnConfig, gen: torch.Generator, device,
                 dtype=torch.float32, trainable_dtype=None,
                 skip_llm: bool = False) -> Dict[str, Any]:
    """Random-init parameter tree with the JAX package's layout, drawn from
    ``gen`` on ``device`` and stored in ``dtype``. ``trainable_dtype`` stores
    the trainable subtrees (``TRAINABLE_KEYS``) in another dtype: training
    keeps f32 master weights there (cast to the compute dtype at use, as the
    JAX package's f32 init is), since AdamW steps of lr ≈ 1e-5 vanish on bf16
    weights. The draws are the same either way.

    ``skip_llm`` leaves the decoder out, for callers that load converted
    weights in its place: at 13B its throwaway bf16 init is 26 GB of device
    memory. The decoder is drawn last, so every other subtree's draws are the
    same with it or without."""
    tdt = dtype if trainable_dtype is None else trainable_dtype
    params = {
        "whisper": init_whisper_encoder(cfg.whisper, gen, device, dtype),
        "qformer": init_qformer(cfg.qformer, gen, device, tdt),
    }
    if cfg.beats is not None:
        params["beats"] = init_beats(cfg.beats, gen, device, dtype)
    if cfg.lora is not None:
        params["lora"] = init_lora(cfg.llm, cfg.lora, gen, device, tdt)
    if not skip_llm:
        params["llm"] = init_decoder(cfg.llm, gen, device, dtype)
    return params


def _beats_bias(cfg: SalmonnConfig, params: Dict[str, Any],
                wavs: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """BEATs' relative-position bias table for clips of ``wavs``' length, or
    None: built once a batch, outside any chunk loop."""
    if cfg.beats is None or wavs is None or not cfg.beats.gated_rel_pos:
        return None
    return beats_bias_table(cfg.beats, params["beats"], beats_num_tokens(cfg.beats, wavs.shape[-1]))


def _features(cfg: SalmonnConfig, params: Dict[str, Any], mels: torch.Tensor,
              wavs: Optional[torch.Tensor], bias: Optional[torch.Tensor]) -> torch.Tensor:
    dt = cfg.compute_dtype
    feats = whisper_encode(cfg.whisper, params["whisper"], mels, dtype=dt)
    if cfg.beats is not None and wavs is not None:
        audio = beats_encode(cfg.beats, params["beats"], wavs, dtype=dt, bias_table=bias)
        audio = F.pad(audio, (0, 0, 0, feats.shape[1] - audio.shape[1]))
        feats = torch.cat([feats, audio], dim=-1)
    return feats


def _chunked(cfg: SalmonnConfig, fn, mels: torch.Tensor,
             wavs: Optional[torch.Tensor]) -> torch.Tensor:
    """``fn(mels, wavs)`` over sequential chunks of ``cfg.encode_chunk`` = c
    clips when N > c is a multiple of c (the peak activation memory is then
    one chunk's), concatenated; else over all N clips at once."""
    n, c = mels.shape[0], cfg.encode_chunk
    if c and n > c and n % c == 0:
        return torch.cat([fn(mels[i:i + c], None if wavs is None else wavs[i:i + c])
                          for i in range(0, n, c)])
    return fn(mels, wavs)


def encoder_features(cfg: SalmonnConfig, params: Dict[str, Any], mels: torch.Tensor,
                     wavs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The frozen encoders: mels (N, 80, 3000) [+ wavs (N, n) for BEATs] →
    (N, 1500, Whisper width [+ BEATs width]), chunked by
    ``cfg.encode_chunk``."""
    bias = _beats_bias(cfg, params, wavs)
    return _chunked(cfg, lambda m, w: _features(cfg, params, m, w, bias), mels, wavs)


def encode_speech(cfg: SalmonnConfig, params: Dict[str, Any], mels: torch.Tensor,
                  wavs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mels (N, 80, 3000) [+ wavs (N, n) for BEATs] → (N, T_a, llm_dim): the
    encoders and the Q-Former, chunked by ``cfg.encode_chunk`` (each chunk
    through both, as the JAX package's ``lax.map`` runs them)."""
    bias = _beats_bias(cfg, params, wavs)
    return _chunked(cfg, lambda m, w: qformer_windows(cfg.qformer, params["qformer"],
                                                      _features(cfg, params, m, w, bias)),
                    mels, wavs)


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


def salmonn_train_loss(cfg: SalmonnConfig, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                       remat=False, pipeline=None, sp=None) -> torch.Tensor:
    """Training forward: packed batch → mean CE over completion tokens.

    ``batch`` (tensors on the model's device): text_tokens, gather_idx,
    seq_mask, shifted_labels, wavs (B, n_slots, n_samples). The mel frontend
    and the frozen Whisper and BEATs encoders run under ``torch.no_grad()``
    (their activations would cost tens of GB at 24 clips × 1500 frames and
    nothing trains there); the Q-Former, the assembly, the decoder (LoRA
    inside, ``remat`` as ``decoder_forward``), the logits and the CE run with
    grad. ``pipeline`` and ``sp`` (the JAX package's multi-chip decoders)
    are not ported."""
    if pipeline is not None or sp is not None:
        raise NotImplementedError("pipeline / sequence-parallel decoders are not ported yet "
                                  "(ROADMAP, parallel slice)")
    B = batch["text_tokens"].shape[0]
    with torch.no_grad():
        wavs = wavs_to_float(batch["wavs"])
        n_slots = wavs.shape[1]
        flat = pad_or_trim(wavs.reshape(B * n_slots, wavs.shape[-1]))
        feats = encoder_features(cfg, params, log_mel_spectrogram(flat),
                                 flat if cfg.beats is not None else None)
    speech = qformer_windows(cfg.qformer, params["qformer"], feats)
    speech = speech.reshape(B, n_slots, -1, cfg.llm.dim)
    seq = assemble_sequence(cfg, params, batch["text_tokens"], speech, batch["gather_idx"])
    lengths = batch["seq_mask"].sum(dim=1).to(torch.int32)
    scaling = cfg.lora.scaling if cfg.lora is not None else 1.0
    hidden, _ = decoder_forward(cfg.llm, params["llm"], seq, lengths, lora=params.get("lora"),
                                lora_scaling=scaling, remat=remat)
    return cross_entropy_loss(lm_logits(cfg.llm, params["llm"], hidden), batch["shifted_labels"])
