"""SALMONN in PyTorch: Whisper + BEATs → window-level Q-Former → LLM (+LoRA).

Counterpart of ``icl_speech_text_llm_tpu/models/salmonn.py``: the configs,
``init_salmonn``, ``encode_speech`` (every clip of the batch — query and
exemplars — through the encoders in one call, or in sequential chunks of
``encode_chunk`` clips), ``assemble_sequence`` (one gather over [pad | text |
speech] embeddings) and ``salmonn_train_loss``.
Generation is in ``inference/engine.py``.

Each stage of every chunk runs inside a profiler range (``utils/perf.py:
span``): ``port/encode.whisper``, ``port/encode.beats`` and
``port/encode.qformer``, nested in the engine's ``port/encode``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..data.packing import IGNORE_INDEX
from ..ops.mel import log_mel_spectrogram, pad_or_trim, wavs_to_float
from ..utils.perf import span
from .beats import BEATS_CONFIGS, BeatsConfig, beats_bias_table, beats_encode, beats_num_tokens, init_beats
from .llama import (
    DECODER_CONFIGS,
    DecoderConfig,
    LoraConfig,
    decoder_forward,
    decoder_loss,
    embed_tokens,
    init_decoder,
    init_lora,
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
    with span("encode.whisper"):
        feats = whisper_encode(cfg.whisper, params["whisper"], mels, dtype=dt)
    if cfg.beats is not None and wavs is not None:
        with span("encode.beats"):
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

    def encode(m, w):
        feats = _features(cfg, params, m, w, bias)
        with span("encode.qformer"):
            return qformer_windows(cfg.qformer, params["qformer"], feats)

    return _chunked(cfg, encode, mels, wavs)


def assemble_sequence(cfg: SalmonnConfig, params: Dict[str, Any], text_tokens: torch.Tensor,
                      speech_embeds: torch.Tensor, gather_idx: torch.Tensor) -> torch.Tensor:
    """One gather builds the interleaved text/speech sequence (B, L_seq, D):
    index 0 is padding, then the text embeddings, then the flattened clips."""
    text_embeds = embed_tokens(params["llm"], text_tokens, dtype=cfg.compute_dtype)
    return gather_sequence(text_embeds, speech_embeds, gather_idx)


def gather_sequence(text_embeds: torch.Tensor, speech_embeds: torch.Tensor,
                    gather_idx: torch.Tensor) -> torch.Tensor:
    """The gather of ``assemble_sequence`` over given text embeddings (B,
    L_text, D) (the symbol adapter transforms them first), in their dtype."""
    B, _, D = text_embeds.shape
    dt = text_embeds.dtype
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
    grad. Under a mesh (``parallel/sharding.py``) the batch is the rank's
    rows, the encoders and the decoder run on their shards and the
    Q-Former replicated, and the loss is the vocab-parallel one.

    ``pipeline=(mesh, n_micro)`` runs the decoder as a GPipe pipeline over
    the mesh's pp axis (``parallel/pipeline.py``): stage 0 alone runs the
    encoders, the Q-Former and the assembly, the last stage alone the
    logits and the CE, and the loss is summed over pp to every stage.
    ``sp=(mesh, axis)`` cuts the decoder's activations along the sequence
    over ``axis`` (``parallel/sequence_parallel.py``): each rank's CE over
    its positions divided by the rows' label count, summed over the axis,
    so the loss is the rows' on every rank and each rank's gradients are
    its partial sums."""
    B, L = batch["gather_idx"].shape
    lengths = batch["seq_mask"].sum(dim=1).to(torch.int32)
    scaling = cfg.lora.scaling if cfg.lora is not None else 1.0
    lora, labels = params.get("lora"), batch["shifted_labels"]
    if pipeline is not None:
        from ..parallel.pipeline import last_stage_loss, pipeline_stage_forward
        from ..parallel.sharding import context_of

        mesh, n_micro = pipeline
        if context_of(mesh).pp_rank == 0:
            seq = _train_sequence(cfg, params, batch)
        else:  # read on stage 0 alone
            seq = torch.zeros((), dtype=cfg.compute_dtype, device=labels.device).expand(
                B, L, cfg.llm.dim)
        out = pipeline_stage_forward(mesh, cfg.llm, params["llm"], seq, lengths, n_micro,
                                     lora=lora, lora_scaling=scaling, remat=remat)
        return last_stage_loss(mesh, lambda h: decoder_loss(cfg.llm, params["llm"], h, labels),
                               out)
    seq = _train_sequence(cfg, params, batch)
    if sp is not None:
        from ..parallel import collectives
        from ..parallel.mesh import axis_group
        from ..parallel.sequence_parallel import sp_hidden, sp_slice

        mesh, axis = sp
        hidden = sp_hidden(mesh, axis, cfg.llm, params["llm"], seq, lengths, lora, scaling,
                           remat)
        mine = labels[:, sp_slice(mesh, axis, L)]
        count = (mine != IGNORE_INDEX).sum()
        total = (labels != IGNORE_INDEX).sum().clamp(min=1)
        part = decoder_loss(cfg.llm, params["llm"], hidden, mine) * (count / total)
        return collectives.ReduceFromGroup.apply(part, axis_group(mesh, axis))
    hidden, _ = decoder_forward(cfg.llm, params["llm"], seq, lengths, lora=lora,
                                lora_scaling=scaling, remat=remat)
    return decoder_loss(cfg.llm, params["llm"], hidden, labels)


def _train_sequence(cfg: SalmonnConfig, params: Dict[str, Any],
                    batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The train loss's decoder input: the frozen encoders without grad,
    then the Q-Former and the assembly (B, L, dim)."""
    B = batch["text_tokens"].shape[0]
    with torch.no_grad():
        wavs = wavs_to_float(batch["wavs"])
        n_slots = wavs.shape[1]
        flat = pad_or_trim(wavs.reshape(B * n_slots, wavs.shape[-1]))
        feats = encoder_features(cfg, params, log_mel_spectrogram(flat),
                                 flat if cfg.beats is not None else None)
    speech = qformer_windows(cfg.qformer, params["qformer"], feats)
    speech = speech.reshape(B, n_slots, -1, cfg.llm.dim)
    return assemble_sequence(cfg, params, batch["text_tokens"], speech, batch["gather_idx"])
