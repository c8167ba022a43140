"""Static generation engine: batched prefill + KV-cached greedy decode.

Counterpart of ``icl_speech_text_llm_tpu/inference/engine.py``:

  1. wavs → log-mel, and every clip through the encoders in one batch;
  2. the ICL sequence assembled with one gather (PackedBatch indices);
  3. causal prefill into a KV cache (128-aligned length);
  4. greedy cached decode, each sample from its own length, tokens forced
     to pad after EOS.

The first token comes from the prefill's logits and each decode step
yields the next, so ``max_new_tokens`` tokens take ``max_new_tokens − 1``
decode steps (the JAX scan computes one more token and discards it).
Decode attention is the JAX package's default ``"xla"`` math in plain
torch; its flash-decode kernel is not ported yet. ``kv_int8`` keeps the
cache in int8 with per-position f32 scales. Sampling, beam search,
repetition penalty and ``min_new_tokens`` are not ported yet: a config
asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from icl_speech_text_llm_tpu.utils.tokenization import Tokenizer

from ..data.packing import PackedBatch
from ..models.llama import decode_step, decoder_forward, embed_tokens, init_kv_cache, lm_logits
from ..ops.mel import log_mel_spectrogram, pad_or_trim, wavs_to_float


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

    def check_supported(self) -> None:
        unsupported = {
            "do_sample": self.do_sample, "num_beams > 1": self.num_beams > 1,
            "repetition_penalty != 1": self.repetition_penalty != 1.0,
            "min_new_tokens > 0": self.min_new_tokens > 0,
        }
        asked = [name for name, on in unsupported.items() if on]
        if asked:
            raise NotImplementedError(
                f"not ported yet: {', '.join(asked)} (the port decodes greedily)")


class StepEvents:
    """CUDA events at the start of the prefill, after it, and after each
    decode step; ``millis()`` is read once the tokens are on the host, so
    timing adds no synchronisation. → [prefill ms, step 1 ms, …]."""

    def __init__(self):
        self.events: List[torch.cuda.Event] = []

    def mark(self) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)

    def millis(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]


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


def decode_from_sequence(llm_cfg, llm_params: Dict[str, Any], seq: torch.Tensor,
                         lengths: torch.Tensor, gen: GenerationConfig, lora=None,
                         lora_scaling: float = 1.0, dt=torch.float32,
                         events: Optional[StepEvents] = None) -> torch.Tensor:
    """Prefill + greedy cached decode → (B, max_new_tokens) int32 token ids;
    ``events`` (CUDA) marks the prefill and each decode step."""
    gen.check_supported()
    mark = events.mark if events is not None else (lambda: None)
    mark()
    B, L, _ = seq.shape
    lengths = lengths.to(device=seq.device, dtype=torch.int32)
    cache_len = -(-(L + gen.max_new_tokens) // 128) * 128
    logits, cache = prefill(llm_cfg, llm_params, seq, lengths, cache_len, lora,
                            lora_scaling, dt, gen.kv_int8)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    mark()
    done = tok == gen.eos_token_id
    toks = [tok]
    cur_len = lengths
    for _ in range(gen.max_new_tokens - 1):
        emb = embed_tokens(llm_params, tok[:, None], dtype=dt)
        hidden, cache = decode_step(llm_cfg, llm_params, emb, cache, cur_len, lora,
                                    lora_scaling)
        nxt = torch.argmax(lm_logits(llm_cfg, llm_params, hidden)[:, 0], dim=-1)
        tok = torch.where(done, torch.full_like(nxt, gen.pad_token_id), nxt).to(torch.int32)
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
def salmonn_generate(cfg, gen: GenerationConfig, params: Dict[str, Any],
                     batch: Dict[str, torch.Tensor],
                     events: Optional[StepEvents] = None) -> torch.Tensor:
    """Packed batch → (B, max_new_tokens) generated token ids. ``batch``:
    text_tokens (B, L_text), gather_idx (B, L_seq), seq_lengths (B,), wavs
    (B, n_slots, n_samples), all on the model's device."""
    seq = speech_sequence(cfg, params, batch)
    scaling = cfg.lora.scaling if cfg.lora is not None else 1.0
    return decode_from_sequence(cfg.llm, params["llm"], seq, batch["seq_lengths"], gen,
                                lora=params.get("lora"), lora_scaling=scaling,
                                dt=cfg.compute_dtype, events=events)


@torch.inference_mode()
def first_token_logits(cfg, params: Dict[str, Any], batch: Dict[str, torch.Tensor]):
    """The logits that pick the first generated token, (B, V): the encoders,
    the assembly and the prefill of ``salmonn_generate``."""
    seq = speech_sequence(cfg, params, batch)
    lengths = batch["seq_lengths"].to(device=seq.device, dtype=torch.int32)
    cache_len = -(-(seq.shape[1] + 1) // 128) * 128
    scaling = cfg.lora.scaling if cfg.lora is not None else 1.0
    return prefill(cfg.llm, params["llm"], seq, lengths, cache_len, params.get("lora"),
                   scaling, cfg.compute_dtype)[0]


class SalmonnEngine:
    """Host-side wrapper: ships a packed batch to the device, generates, and
    decodes rows to strings (API of the JAX package's SalmonnEngine). On a
    CUDA device ``timings`` collects each batch's [prefill ms, decode step
    ms, …] (CUDA events)."""

    def __init__(self, cfg, params, tokenizer: Tokenizer, gen: Optional[GenerationConfig] = None,
                 device: Optional[torch.device] = None):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.gen = gen or GenerationConfig(eos_token_id=tokenizer.eos_token_id,
                                           pad_token_id=tokenizer.pad_token_id)
        self.gen.check_supported()
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.timings: List[List[float]] = []

    def generate_tokens(self, packed: PackedBatch, audio: Dict[str, np.ndarray]) -> np.ndarray:
        batch = {
            "text_tokens": packed.text_tokens, "gather_idx": packed.gather_idx,
            "seq_lengths": packed.seq_lengths, **audio,
        }
        batch = {k: torch.as_tensor(np.asarray(v), device=self.device) for k, v in batch.items()}
        events = StepEvents() if self.device.type == "cuda" else None
        toks = salmonn_generate(self.cfg, self.gen, self.params, batch, events).cpu().numpy()
        if events is not None:
            self.timings.append(events.millis())
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
