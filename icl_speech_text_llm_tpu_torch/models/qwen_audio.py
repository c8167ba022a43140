"""Qwen2-Audio in PyTorch: Whisper-style audio tower → average pool →
final LN → projector → Qwen2 LLM (+LoRA).

Counterpart of ``icl_speech_text_llm_tpu/models/qwen_audio.py`` (ref:
models/custom_qwen.py:29-247): the configs, ``init_qwen_audio``, the length
formulas the host packer and the device mask share, ``encode_audio``,
``qwen_sequence`` (the same one-gather assembly as SALMONN, 750 audio
positions a slot of which each clip splices ``audio_output_length(n)``),
``qwen_audio_train_loss`` and ``qwen_audio_generate``. The tower's
self-attention is K2 with each clip's valid frame count as its key length,
and the tower runs only up to one frame past each batch's longest clip
(``tower_frames``), not the 30-s pad.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.mel import log_mel_spectrogram, pad_or_trim, wavs_to_float
from .common import dense_init, layer_norm, linear
from .llama import (
    DECODER_CONFIGS,
    DecoderConfig,
    LoraConfig,
    decoder_forward,
    decoder_loss,
    init_decoder,
    init_lora,
)
from ..parallel.sharding import shard_context
from .salmonn import assemble_sequence
from .whisper import WHISPER_CONFIGS, WhisperEncoderConfig, init_whisper_encoder, whisper_encode


def audio_feat_lengths(n_samples, hop: int = 160):
    """Raw 16 kHz sample count → valid post-conv encoder frames: n // hop mel
    frames, then the stride-2 conv's (mel − 1) // 2 + 1 (HF
    ``Qwen2AudioEncoder._get_feat_extract_output_lengths``). Integer floor
    division on ints, numpy arrays and tensors alike."""
    mel = n_samples // hop
    return (mel - 1) // 2 + 1


def audio_output_length(n_samples, hop: int = 160):
    """Raw 16 kHz sample count → audio positions spliced after the stride-2
    average pool, (feat − 2) // 2 + 1; 480000 samples → 750. The packer's
    gather and the tower's key mask both use it, so they always agree."""
    return (audio_feat_lengths(n_samples, hop) - 2) // 2 + 1


@dataclass(frozen=True)
class QwenAudioConfig:
    encoder: WhisperEncoderConfig
    llm: DecoderConfig
    lora: Optional[LoraConfig] = LoraConfig(rank=8, alpha=32.0, targets=("wq", "wk"))
    pool_stride: int = 2
    compute_dtype: Any = torch.float32

    @property
    def audio_tokens_per_slot(self) -> int:
        return self.encoder.n_ctx // self.pool_stride  # 750 for 30 s

    @property
    def audio_len_fn(self):
        """Each clip's splice count for ``PackConfig`` (HF
        feature_attention_mask semantics)."""
        return audio_output_length


def qwen2_audio_7b() -> QwenAudioConfig:
    """Qwen2-Audio-7B-Instruct (ref: models/custom_qwen.py:51): the tower is
    Whisper-large-v2's shape over 128 mel bins, the decoder Qwen2-7B."""
    return QwenAudioConfig(encoder=dataclasses.replace(WHISPER_CONFIGS["large-v2"], n_mels=128),
                           llm=DECODER_CONFIGS["qwen2-7b"], compute_dtype=torch.bfloat16)


def qwen2_audio_tiny() -> QwenAudioConfig:
    """CPU-testable config; the LLM uses the TinyTokenizer vocabulary."""
    return QwenAudioConfig(encoder=WHISPER_CONFIGS["tiny-test"], llm=DECODER_CONFIGS["tiny"],
                           lora=LoraConfig(rank=4, alpha=8.0, targets=("wq", "wk")))


def qwen2_audio_smoke() -> QwenAudioConfig:
    """Qwen2-0.5B backbone with a small tower."""
    return QwenAudioConfig(encoder=WhisperEncoderConfig(dim=128, n_heads=4, n_layers=2),
                           llm=DECODER_CONFIGS["qwen2-0.5b"])


def init_qwen_audio(cfg: QwenAudioConfig, gen: torch.Generator, device, dtype=torch.float32,
                    trainable_dtype=None, skip_llm: bool = False) -> Dict[str, Any]:
    """Random-init parameter tree with the JAX package's layout, drawn from
    ``gen`` on ``device`` in ``dtype``: the encoder, the projector, the LoRA
    (in ``trainable_dtype`` when given), and the decoder last, so that
    ``skip_llm`` (converted weights load in its place) leaves every other
    draw unchanged."""
    params = {
        "encoder": init_whisper_encoder(cfg.encoder, gen, device, dtype),
        "projector": {"w": dense_init(gen, cfg.encoder.dim, cfg.llm.dim, device, dtype),
                      "b": torch.zeros((cfg.llm.dim,), device=device, dtype=dtype)},
    }
    if cfg.lora is not None:
        params["lora"] = init_lora(cfg.llm, cfg.lora, gen, device,
                                   dtype if trainable_dtype is None else trainable_dtype)
    if not skip_llm:
        params["llm"] = init_decoder(cfg.llm, gen, device, dtype)
    return params


#: the tower runs post-conv frames in multiples of this (at most 12 shapes
#: over a 30-s pad)
TOWER_BUCKET = 128


def tower_frames(frame_lengths, n_frames: int = 1500) -> int:
    """Post-conv frames the tower runs for clips of ``frame_lengths`` valid
    frames out of ``n_frames``: one past the longest clip's, rounded up to
    ``TOWER_BUCKET``, at most ``n_frames``. The frame past the longest keeps
    every valid frame exact: a cut mel's last post-conv frame reads, through
    conv2's stride-2 window and conv1's, the mel frame just past the cut
    (zero there, a pad frame in the whole mel), so only that frame differs.
    ``frame_lengths`` a numpy array or a tensor; a device tensor costs a
    sync (``host_tower_frames`` reads the host copy instead)."""
    longest = int(frame_lengths.max())
    return min(n_frames, -(-(longest + 1) // TOWER_BUCKET) * TOWER_BUCKET)


def host_tower_frames(audio_lengths) -> int:
    """``tower_frames`` of a packed batch's host ``audio_lengths`` (raw
    samples a slot): the batch's ``"tower_frames"`` entry, which spares
    ``encode_batch_audio`` its read of the device copy."""
    return tower_frames(audio_feat_lengths(np.asarray(audio_lengths)))


def encode_audio(cfg: QwenAudioConfig, params: Dict[str, Any], mels: torch.Tensor,
                 sample_lengths: Optional[torch.Tensor] = None,
                 run_frames: Optional[int] = None) -> torch.Tensor:
    """(N, n_mels, 3000) mel → (N, 750, llm_dim) audio positions, in HF's
    order: the tower's layers, the stride-2 average pool, THEN the final LN,
    then the projector. ``sample_lengths`` (N,) valid raw samples a clip:
    the tower's keys past ``audio_feat_lengths(n)`` are masked, and only
    positions below ``audio_output_length(n)`` carry meaning (the packed
    gather splices that many). With them the tower runs only the mel's
    first 2T' frames, T' = ``tower_frames`` (one frame past the batch's
    longest clip, in buckets of 128; 1500 with a 30-s or missing clip), and
    the positions from T'/2 to 750 are zeros: every spliced position is the
    30-s tower's. The mel is computed over the 30-s pad all the same, so its
    clamp is unchanged. ``run_frames``: T' as the caller read it from a
    host copy of the lengths (``host_tower_frames``); when None it is read
    from ``sample_lengths``, one sync if they are on the device. Without
    lengths all 1500 frames run. The tower (``encoder/…``) matches no
    sharding rule: under a mesh it stays whole and runs unsharded, as in
    JAX."""
    dt = cfg.compute_dtype
    n_frames = (mels.shape[-1] - 1) // 2 + 1  # post-conv frames of the whole mel
    run, frames = n_frames, None
    if sample_lengths is not None:
        frames = audio_feat_lengths(sample_lengths.long())
        run = tower_frames(frames, n_frames) if run_frames is None else run_frames
    with shard_context(None):
        feats = whisper_encode(cfg.encoder, params["encoder"], mels[..., :2 * run], dtype=dt,
                               apply_ln_post=False, frame_lengths=frames)
    N, T, D = feats.shape
    s = cfg.pool_stride
    pooled = feats[:, :(T // s) * s].reshape(N, T // s, s, D).mean(dim=2)
    ln = params["encoder"]["ln_post"]
    pooled = layer_norm(pooled, ln["w"], ln["b"])
    out = linear(pooled, params["projector"]["w"], params["projector"]["b"])
    return F.pad(out, (0, 0, 0, n_frames // s - T // s))


def encode_batch_audio(cfg: QwenAudioConfig, params: Dict[str, Any],
                       batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """A packed batch's clips (wavs (B, n_slots, n), audio_lengths (B,
    n_slots) when packed with ``audio_len_fn``, and the host's
    ``tower_frames`` where the caller has it) → (B, n_slots, 750, llm_dim)."""
    B = batch["text_tokens"].shape[0]
    wavs = wavs_to_float(batch["wavs"])
    n_slots = wavs.shape[1]
    flat = pad_or_trim(wavs.reshape(B * n_slots, wavs.shape[-1]))
    mels = log_mel_spectrogram(flat, cfg.encoder.n_mels)
    lengths = batch.get("audio_lengths")
    if lengths is not None:
        lengths = lengths.reshape(B * n_slots)
    return encode_audio(cfg, params, mels, lengths, batch.get("tower_frames")).reshape(
        B, n_slots, -1, cfg.llm.dim)


def qwen_sequence(cfg: QwenAudioConfig, params: Dict[str, Any],
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Packed batch → the assembled prompt embeddings (B, L_seq, D)."""
    audio = encode_batch_audio(cfg, params, batch)
    return assemble_sequence(cfg, params, batch["text_tokens"], audio, batch["gather_idx"])


def qwen_audio_train_loss(cfg: QwenAudioConfig, params: Dict[str, Any],
                          batch: Dict[str, torch.Tensor], remat=False) -> torch.Tensor:
    """Training forward (ref: models/custom_qwen.py:141-145): packed batch →
    mean CE over completion tokens. The frozen tower and projector run under
    ``torch.no_grad()``; the assembly, the decoder (LoRA inside, ``remat``
    as ``decoder_forward``), the logits and the CE run with grad."""
    with torch.no_grad():
        audio = encode_batch_audio(cfg, params, batch)
    seq = assemble_sequence(cfg, params, batch["text_tokens"], audio, batch["gather_idx"])
    lengths = batch["seq_mask"].sum(dim=1).to(torch.int32)
    scaling = cfg.lora.scaling if cfg.lora is not None else 1.0
    hidden, _ = decoder_forward(cfg.llm, params["llm"], seq, lengths, lora=params.get("lora"),
                                lora_scaling=scaling, remat=remat)
    return decoder_loss(cfg.llm, params["llm"], hidden, batch["shifted_labels"])


def qwen_audio_generate(cfg: QwenAudioConfig, gen, params: Dict[str, Any],
                        batch: Dict[str, torch.Tensor], events=None) -> torch.Tensor:
    """Packed batch → (B, max_new_tokens) token ids: greedy, sampled, the
    history processors or beams, as ``inference/engine.py:salmonn_generate``
    over Qwen2-Audio's sequence (ref: models/custom_qwen.py:199-247)."""
    from ..inference.engine import generate_batch

    return generate_batch(cfg, gen, params, batch, qwen_sequence, events)
