"""Fixed-shape ICL sequence packing.

The reference assembles ICL prompts per sample in Python inside the model
forward — tokenize text parts, embed, splice speech embeddings at markers,
``torch.cat`` + ``torch.stack`` (ref: models/custom_salmon.py:115-299). That
forces batch_size=1 (stack needs equal lengths; SURVEY.md §8 item 3) and
recompiles per shape.

TPU-native design: the host emits a PackedBatch of static-shape arrays and the
device assembles the embedding sequence with ONE gather:

    table      = [zeros(1) | text_embeds (L_text) | audio_embeds (n_slots*T_a)]
    sequence   = table[gather_idx]            # (B, L_seq, D)

where every audio slot occupies a fixed T_a positions (the window-level
Q-Former emits exactly ``n_windows`` tokens per 30 s clip — static). Per-sample
variation lives only in index arrays and masks, so one compiled program serves
every batch.

Labels follow the reference convention: -100 over prompt and padding, token
ids over the completion (ref: models/custom_salmon.py:617-627).

A copy of ``icl_speech_text_llm_tpu/data/packing.py`` with only the
imports changed: every JAX-package ``data`` module imports through
``data/__init__``, whose ``collate`` pulls in jax through ``ops.mel``.
The framework-free ``registry``, ``utils.tokenization`` and ``utils.native``
are still imported from the JAX package. Keep the copies in step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..utils.tokenization import Tokenizer
from .prompts import PromptPlan

IGNORE_INDEX = -100


@dataclass
class PackConfig:
    """Static shape budget for one compiled program."""

    seq_len: int = 2048  # L_seq: total assembled positions incl. completion
    text_len: int = 1024  # L_text: budget for text tokens (prompt + completion)
    max_slots: int = 6  # audio slots per sample (k exemplars + main; SQA: 2k+2)
    audio_tokens_per_slot: int = 88  # Q-Former windows per clip
    completion_len: int = 32  # completion token budget (train targets)
    #: raw wav sample count → audio positions for that clip (None → every
    #: slot occupies the full audio_tokens_per_slot budget). Qwen2-Audio sets
    #: models.qwen_audio.audio_output_length here — the reference's per-clip
    #: feature_attention_mask splice count (ref: models/custom_qwen.py:174-185).
    audio_len_fn: Optional[Any] = None


@dataclass
class PackedSample:
    """Host-side intermediate: one sample's segments + slots, tokenized."""

    segment_tokens: List[List[int]]
    slots: List[tuple]
    completion_tokens: List[int]
    prompt: str
    completion: str
    extras: Dict[str, Any] = field(default_factory=dict)
    #: per-slot audio positions to splice (None → full audio_tokens_per_slot).
    #: Qwen2-Audio's variable-length semantics: clip i contributes
    #: slot_token_counts[i] ≤ T_a positions (the first ones of its slot block)
    #: — the packed equivalent of HF's feature_attention_mask splice
    #: (ref: models/custom_qwen.py:174-185).
    slot_token_counts: Optional[List[int]] = None


@dataclass
class PackedBatch:
    """Device-ready arrays (all numpy; converted to jnp at dispatch)."""

    text_tokens: np.ndarray  # (B, L_text) int32, prompt-part tokens then completion
    gather_idx: np.ndarray  # (B, L_seq) int32 into [pad | text | audio] table
    seq_mask: np.ndarray  # (B, L_seq) bool
    seq_lengths: np.ndarray  # (B,) prompt length in assembled positions
    labels: np.ndarray  # (B, L_seq) int32, -100 outside completion
    num_slots_used: np.ndarray  # (B,) int32
    prompts: List[str]
    completions: List[str]
    extras: List[Dict[str, Any]] = field(default_factory=list)
    # audio payloads are attached by the model-specific collator:
    audio: Dict[str, np.ndarray] = field(default_factory=dict)
    labels_shifted: Optional[np.ndarray] = None  # next-token-aligned labels

    @property
    def batch_size(self) -> int:
        return self.text_tokens.shape[0]


class PackError(ValueError):
    """A sample exceeded the static shape budget (caller should re-bucket)."""


def required_config(samples: Sequence["PackedSample"], cfg: PackConfig) -> PackConfig:
    """The smallest grown PackConfig that fits ``samples``.

    Budgets round up to coarse steps (text 128, seq 256) so one oversized
    batch adds at most one new compiled shape — the TPU version of the
    reference's "just runs slower" degradation (round-1 VERDICT weak #9:
    PackError had no re-bucketing path). Returns ``cfg`` unchanged when
    everything already fits.
    """
    need_text, need_seq, need_slots = cfg.text_len, cfg.seq_len, cfg.max_slots
    for s in samples:
        n_text = sum(len(t) for t in s.segment_tokens) + len(s.completion_tokens)
        if s.slot_token_counts is not None:
            n_audio = sum(min(c, cfg.audio_tokens_per_slot) for c in s.slot_token_counts)
        else:
            n_audio = len(s.slots) * cfg.audio_tokens_per_slot
        n_seq = n_text + n_audio
        need_text = max(need_text, -(-n_text // 128) * 128)
        need_seq = max(need_seq, -(-n_seq // 256) * 256)
        need_slots = max(need_slots, len(s.slots))
    if (need_text, need_seq, need_slots) == (cfg.text_len, cfg.seq_len, cfg.max_slots):
        return cfg
    import dataclasses

    return dataclasses.replace(
        cfg, text_len=need_text, seq_len=need_seq, max_slots=need_slots)


def tokenize_plan(
    tokenizer: Tokenizer, plan: PromptPlan, completion: str, extras=None
) -> PackedSample:
    """Tokenize a PromptPlan's segments (no special tokens — matches the
    reference's part-wise tokenization, models/custom_salmon.py:178-181)."""
    return PackedSample(
        segment_tokens=[tokenizer.encode(seg, add_special_tokens=False) for seg in plan.segments],
        slots=list(plan.slots),
        completion_tokens=tokenizer.encode(completion, add_special_tokens=False),
        prompt=plan.prompt,
        completion=completion,
        extras=extras or {},
    )


def pack_batch(samples: Sequence[PackedSample], cfg: PackConfig) -> PackedBatch:
    """Assemble host-side index arrays for a batch of tokenized samples."""
    B = len(samples)
    L_seq, L_text, T_a = cfg.seq_len, cfg.text_len, cfg.audio_tokens_per_slot

    text_tokens = np.zeros((B, L_text), np.int32)
    gather_idx = np.zeros((B, L_seq), np.int32)  # 0 = pad row of the table
    seq_mask = np.zeros((B, L_seq), bool)
    labels = np.full((B, L_seq), IGNORE_INDEX, np.int32)
    seq_lengths = np.zeros((B,), np.int32)
    num_slots = np.zeros((B,), np.int32)

    audio_base = 1 + L_text  # table = [pad(1) | text(L_text) | audio(slots*T_a)]

    for b, s in enumerate(samples):
        if len(s.slots) > cfg.max_slots:
            raise PackError(f"sample {b}: {len(s.slots)} audio slots > budget {cfg.max_slots}")
        flat_tokens: List[int] = []
        positions: List[int] = []  # gather indices for the assembled sequence

        def push_text(toks):
            start = len(flat_tokens)
            flat_tokens.extend(toks)
            # +1: row 0 of the table is the pad row
            positions.extend(range(1 + start, 1 + start + len(toks)))

        counts = s.slot_token_counts
        for i, seg_toks in enumerate(s.segment_tokens):
            push_text(seg_toks)
            if i < len(s.slots):
                slot_start = audio_base + i * T_a
                n_i = T_a if counts is None else min(counts[i], T_a)
                positions.extend(range(slot_start, slot_start + n_i))

        prompt_len = len(positions)
        completion_start = prompt_len
        push_text(s.completion_tokens)

        if len(flat_tokens) > L_text:
            raise PackError(f"sample {b}: {len(flat_tokens)} text tokens > budget {L_text}")
        if len(positions) > L_seq:
            raise PackError(f"sample {b}: {len(positions)} positions > budget {L_seq}")

        text_tokens[b, : len(flat_tokens)] = flat_tokens
        gather_idx[b, : len(positions)] = positions
        seq_mask[b, : len(positions)] = True
        seq_lengths[b] = prompt_len
        num_slots[b] = len(s.slots)
        labels[b, completion_start : completion_start + len(s.completion_tokens)] = (
            s.completion_tokens
        )

    return PackedBatch(
        text_tokens=text_tokens,
        gather_idx=gather_idx,
        seq_mask=seq_mask,
        seq_lengths=seq_lengths,
        labels=labels,
        num_slots_used=num_slots,
        prompts=[s.prompt for s in samples],
        completions=[s.completion for s in samples],
        extras=[s.extras for s in samples],
    )


def shift_labels(labels: np.ndarray) -> np.ndarray:
    """Align labels for next-token prediction: logits at position p predict
    labels[p+1] (HF causal-LM shift, done once on host)."""
    shifted = np.full_like(labels, IGNORE_INDEX)
    shifted[:, :-1] = labels[:, 1:]
    return shifted
