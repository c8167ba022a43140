"""Static generation engine: batched prefill + KV-cached decode.

Counterpart of ``icl_speech_text_llm_tpu/inference/engine.py``:

  1. wavs → log-mel, and every clip through the encoders in one batch;
  2. the ICL sequence assembled with one gather (PackedBatch indices);
  3. causal prefill into a KV cache (128-aligned length);
  4. cached decode, each sample from its own length, tokens forced to pad
     after EOS: greedy or sampled (temperature, top-p), with the repetition
     penalty and the ``min_new_tokens`` EOS ban over the generated history;
     ``num_beams > 1`` takes beam search (``inference/beam.py``).

The first token comes from the prefill's logits and each decode step
yields the next, so ``max_new_tokens`` tokens take ``max_new_tokens − 1``
decode steps (the JAX scan computes one more token and discards it).
Decode attention follows ``use_flash_decode``: ``"xla"`` (the default, the
JAX package's fused-slice math in plain torch), ``True`` (the K7
flash-decode kernel) or ``False`` (JAX's scanned-layer path: each layer's
row appended first, then the plain masked attention over the cache).
``kv_int8`` keeps the cache in int8 with per-position f32 scales.

Spans (``utils/perf.py:span``, where a profiler records): ``port/encode``
around the family's ``sequence_fn``, ``port/prefill`` (the prefill and
the first token) and ``port/decode`` (the decode loop) in each decoder,
and ``port/h2d`` / ``port/d2h`` around ``SalmonnEngine``'s copies.

Under a mesh (any call inside ``parallel/sharding.py:shard_context``;
``SalmonnEngine.shard``) the parameters are the rank's
blocks and the batch its rows over (dp, fsdp): the encoders and the
decoder run on the rank's heads (K7 per rank on its KV heads with
``True``, JAX's ``shard_map`` route), or on every head where tp does not
divide a model's heads (the split-head path, ``models/llama.py``: the
cache then holds every KV head, and ``True`` takes the plain decode math,
as JAX's gate under a mesh does), and every decoder here works on the
logits gathered over tp (B × V), so greedy, sampling (the same generator
seed on every rank), the processors and beams pick the same tokens on
every tp rank, an argmax tie keeping the lowest global index. Sampling draws from a ``torch.Generator`` seeded
with ``seed`` for each call, as the JAX engine uses ``PRNGKey(0)``; the two
give different numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..data.packing import PackedBatch
from ..models.llama import (
    DecodeAttention,
    decode_step,
    decoder_forward,
    embed_tokens,
    init_kv_cache,
    lm_logits,
)
from ..models.qwen_audio import host_tower_frames
from ..ops.mel import log_mel_spectrogram, pad_or_trim, wavs_to_float
from ..parallel.sharding import shard_context
from ..utils.perf import StepEvents, device_events, span
from ..utils.tokenization import Tokenizer


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 10
    do_sample: bool = False
    temperature: float = 0.8
    top_p: float = 0.9
    eos_token_id: int = 2
    pad_token_id: int = 0
    num_beams: int = 1
    repetition_penalty: float = 1.0
    length_penalty: float = 1.0
    min_new_tokens: int = 0
    kv_int8: bool = False
    #: JAX's values "xla" (default), True (K7) or False (the scanned-layer
    #: route), stored as a ``DecodeAttention``
    use_flash_decode: Any = "xla"
    seed: int = 0  # of the sampling generator, made anew for each call

    def __post_init__(self):
        object.__setattr__(self, "use_flash_decode", DecodeAttention.of(self.use_flash_decode))

    @property
    def needs_history(self) -> bool:
        return self.repetition_penalty != 1.0 or self.min_new_tokens > 0


def prefill(llm_cfg, llm_params: Dict[str, Any], seq: torch.Tensor, lengths: torch.Tensor,
            cache_len: int, lora=None, lora_scaling: float = 1.0, dt=torch.float32,
            kv_int8: bool = False):
    """Causal prefill of seq (B, L, D) into a new cache of ``cache_len``
    positions (int8 with scales when ``kv_int8``) → (logits at each sample's
    last prompt position (B, V), cache)."""
    B = seq.shape[0]
    cache = init_kv_cache(llm_cfg, B, cache_len, dtype=dt, device=seq.device, quant=kv_int8)
    hidden, cache = decoder_forward(llm_cfg, llm_params, seq, lengths, cache=cache,
                                    lora=lora, lora_scaling=lora_scaling)
    last = hidden[torch.arange(B, device=seq.device), lengths.long() - 1]
    return lm_logits(llm_cfg, llm_params, last), cache


def apply_repetition_penalty(scores: torch.Tensor, history: torch.Tensor, hist_len: int,
                             penalty: float) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor over the generated history:
    scores (N, V) f32, history (N, T) token ids of which the first
    ``hist_len`` count; a seen token's score is multiplied by ``penalty`` if
    negative, else divided by it."""
    if penalty == 1.0:
        return scores
    N, V = scores.shape
    valid = torch.arange(history.shape[1], device=history.device)[None, :] < hist_len
    idx = torch.where(valid, history.long(), torch.full_like(history, V, dtype=torch.long))
    appeared = torch.zeros((N, V + 1), dtype=torch.bool, device=scores.device)
    appeared.scatter_(1, idx, True)
    return torch.where(appeared[:, :V],
                       torch.where(scores < 0, scores * penalty, scores / penalty), scores)


def _process_logits(logits: torch.Tensor, history: torch.Tensor, step: int,
                    gen: GenerationConfig) -> torch.Tensor:
    """HF processor order on the raw (B, V) logits (the beam step's
    log-probs), in f32, shared by the greedy, sampling and beam decoders: the
    repetition penalty over the first ``step`` generated tokens, then the
    EOS ban while fewer than ``min_new_tokens`` are generated."""
    logits = logits.float()
    if gen.repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, history, step, gen.repetition_penalty)
    if gen.min_new_tokens > 0 and step < gen.min_new_tokens:
        logits = logits.clone()
        logits[:, gen.eos_token_id] = float("-inf")
    return logits


def top_p_mask(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """The JAX engine's nucleus cut on (B, V) f32 logits: sorted descending,
    the cutoff is the logit at index #(cumulative probability < top_p);
    logits below it become −inf (ties with the cutoff stay)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    return logits.masked_fill(logits < cutoff, float("-inf"))


def _sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                  gen: GenerationConfig) -> torch.Tensor:
    """(B, V) logits → (B,) token ids: argmax, or with ``do_sample`` the
    temperature, the top-p cut, then a categorical draw from ``generator``.
    (A cutoff index past the vocabulary, which JAX's fill-mode gather turns
    into NaN and so masks nothing, clamps to the smallest logit here: the
    same nothing.)"""
    if not gen.do_sample:
        return torch.argmax(logits, dim=-1)
    masked = top_p_mask(logits.float() / gen.temperature, gen.top_p)
    probs = torch.softmax(masked, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sampling_generator(gen: GenerationConfig, device) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``gen.seed`` when sampling."""
    if not gen.do_sample:
        return None
    return torch.Generator(device=device).manual_seed(gen.seed)


def decode_from_sequence(llm_cfg, llm_params: Dict[str, Any], seq: torch.Tensor,
                         lengths: torch.Tensor, gen: GenerationConfig, lora=None,
                         lora_scaling: float = 1.0, dt=torch.float32,
                         events: Optional[StepEvents] = None) -> torch.Tensor:
    """Prefill + cached decode (greedy or sampled, with the history
    processors) → (B, max_new_tokens) int32 token ids; ``events`` (CUDA)
    marks the prefill and each decode step."""
    mark = events.mark if events is not None else (lambda: None)
    with span("prefill"):
        mark()
        B, L, _ = seq.shape
        lengths = lengths.to(device=seq.device, dtype=torch.int32)
        cache_len = -(-(L + gen.max_new_tokens) // 128) * 128
        logits, cache = prefill(llm_cfg, llm_params, seq, lengths, cache_len, lora,
                                lora_scaling, dt, gen.kv_int8)
        rng = sampling_generator(gen, seq.device)
        history = None
        if gen.needs_history:
            history = torch.full((B, gen.max_new_tokens), gen.pad_token_id, dtype=torch.int32,
                                 device=seq.device)
            logits = _process_logits(logits, history, 0, gen)
        tok = _sample_token(logits, rng, gen).to(torch.int32)
        if history is not None:
            history[:, 0] = tok
        mark()
    done = tok == gen.eos_token_id
    toks = [tok]
    cur_len = lengths
    with span("decode"):
        for t in range(1, gen.max_new_tokens):
            emb = embed_tokens(llm_params, tok[:, None], dtype=dt)
            hidden, cache = decode_step(llm_cfg, llm_params, emb, cache, cur_len, lora,
                                        lora_scaling, gen.use_flash_decode)
            logits = lm_logits(llm_cfg, llm_params, hidden)[:, 0]
            if history is not None:
                logits = _process_logits(logits, history, t, gen)
            nxt = _sample_token(logits, rng, gen)
            tok = torch.where(done, torch.full_like(nxt, gen.pad_token_id), nxt).to(torch.int32)
            if history is not None:
                history[:, t] = tok
            done = done | (tok == gen.eos_token_id)
            toks.append(tok)
            cur_len = cur_len + 1
            mark()
    return torch.stack(toks, dim=1)


def speech_sequence(cfg, params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
    """Packed batch → the assembled prompt embeddings (B, L_seq, D)."""
    from ..models.salmonn import assemble_sequence, encode_speech

    B = batch["text_tokens"].shape[0]
    wavs = wavs_to_float(batch["wavs"])
    n_slots = wavs.shape[1]
    flat = pad_or_trim(wavs.reshape(B * n_slots, wavs.shape[-1]))
    mels = log_mel_spectrogram(flat)
    speech = encode_speech(cfg, params, mels, flat if cfg.beats is not None else None)
    speech = speech.reshape(B, n_slots, -1, cfg.llm.dim)
    return assemble_sequence(cfg, params, batch["text_tokens"], speech, batch["gather_idx"])


@torch.inference_mode()
def generate_batch(cfg, gen: GenerationConfig, params: Dict[str, Any],
                   batch: Dict[str, torch.Tensor], sequence_fn,
                   events: Optional[StepEvents] = None) -> torch.Tensor:
    """Packed batch → (B, max_new_tokens) generated token ids, the prompt
    embeddings from the model family's ``sequence_fn(cfg, params, batch)``
    (SALMONN's ``speech_sequence``, Qwen2-Audio's ``qwen_sequence``).
    ``batch``: text_tokens (B, L_text), gather_idx (B, L_seq), seq_lengths
    (B,), wavs (B, n_slots, n_samples) [, audio_lengths], all on the
    model's device. ``num_beams > 1`` decodes with beam search."""
    with span("encode"):
        seq = sequence_fn(cfg, params, batch)
    scaling = cfg.lora.scaling if cfg.lora is not None else 1.0
    decode = decode_from_sequence
    if gen.num_beams > 1:
        from .beam import beam_decode_from_sequence

        decode = beam_decode_from_sequence
    return decode(cfg.llm, params["llm"], seq, batch["seq_lengths"], gen,
                  lora=params.get("lora"), lora_scaling=scaling, dt=cfg.compute_dtype,
                  events=events)


def salmonn_generate(cfg, gen: GenerationConfig, params: Dict[str, Any],
                     batch: Dict[str, torch.Tensor],
                     events: Optional[StepEvents] = None) -> torch.Tensor:
    """``generate_batch`` over SALMONN's ``speech_sequence``."""
    return generate_batch(cfg, gen, params, batch, speech_sequence, events)


@torch.inference_mode()
def first_token_logits(cfg, params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                       sequence_fn=speech_sequence):
    """The logits that pick the first generated token, (B, V): the family's
    ``sequence_fn`` (the encoders and the assembly) and the prefill of
    ``generate_batch``."""
    seq = sequence_fn(cfg, params, batch)
    lengths = batch["seq_lengths"].to(device=seq.device, dtype=torch.int32)
    cache_len = -(-(seq.shape[1] + 1) // 128) * 128
    scaling = cfg.lora.scaling if cfg.lora is not None else 1.0
    return prefill(cfg.llm, params["llm"], seq, lengths, cache_len, params.get("lora"),
                   scaling, cfg.compute_dtype)[0]


class SalmonnEngine:
    """Host-side wrapper: ships a packed batch to the device, generates, and
    decodes rows to strings (API of the JAX package's SalmonnEngine). On a
    CUDA device ``timings`` collects each batch's [prefill ms, decode step
    ms, …] and ``encode_timings`` each batch's ms from the start of its
    ``sequence_fn`` to the start of its prefill (CUDA events, read once the
    tokens are on the host). ``sequence_fn`` builds the family's prompt
    embeddings (``generate_batch``). ``shard``: a sharded mesh's shard
    context (the params then the rank's blocks, as a sharded training loop
    sets them), under which every batch runs; every tp rank returns the
    same tokens."""

    def __init__(self, cfg, params, tokenizer: Tokenizer, gen: Optional[GenerationConfig] = None,
                 device="cuda", sequence_fn=speech_sequence):
        self.cfg = cfg
        self.shard = None
        self.sequence_fn = sequence_fn
        self.params = params
        self.tokenizer = tokenizer
        self.gen = gen or GenerationConfig(eos_token_id=tokenizer.eos_token_id,
                                           pad_token_id=tokenizer.pad_token_id)
        self.device = torch.device(device)
        self.timings: List[List[float]] = []
        self.encode_timings: List[float] = []

    def generate_tokens(self, packed: PackedBatch, audio: Dict[str, np.ndarray]) -> np.ndarray:
        batch = {
            "text_tokens": packed.text_tokens, "gather_idx": packed.gather_idx,
            "seq_lengths": packed.seq_lengths, **audio,
        }
        with span("h2d"):
            batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                     for k, v in batch.items()}
        if "audio_lengths" in audio:  # Qwen2-Audio's tower frames, from the host copy
            batch["tower_frames"] = host_tower_frames(audio["audio_lengths"])
        events = device_events(self.device)
        if events is not None:
            events.mark()  # the encode's start; the decoder's first mark ends it
        with shard_context(self.shard):
            toks = generate_batch(self.cfg, self.gen, self.params, batch, self.sequence_fn,
                                  events)
        with span("d2h"):
            toks = toks.cpu().numpy()
        if events is not None:
            encode_ms, *step_ms = events.millis()
            self.encode_timings.append(encode_ms)
            self.timings.append(step_ms)
        return toks

    def generate(self, packed: PackedBatch, audio: Dict[str, np.ndarray]) -> List[str]:
        return self.decode_rows(self.generate_tokens(packed, audio))

    def decode_rows(self, toks: np.ndarray) -> List[str]:
        """EOS-truncate + detokenize generated rows."""
        out = []
        for row in toks:
            ids = []
            for t in row:
                if t == self.gen.eos_token_id:
                    break
                ids.append(int(t))
            out.append(self.tokenizer.decode(ids, skip_special_tokens=True))
        return out

