"""Model-specific collation: raw per-sample items → PackedBatch + audio arrays.

Replaces the reference's SalmonProcessor.process_inputs / collate_batch
(ref: data/model_processors.py:616-681,786-874): mel extraction moves from
per-item host torch code into one batched jittable call, and exemplar audio is
packed to a fixed (B, n_slots, ...) block (zero-filled like the reference's
zero-spectrogram padding, ref :846-849).

A copy of ``icl_speech_text_llm_tpu/data/collate.py`` with only the
imports changed: the JAX package's ``collate`` takes ``N_SAMPLES`` from
its jax-backed ``ops.mel`` (here it comes from the port's ``ops/mel``),
and every ``data`` module imports through ``data/__init__``, which
imports ``collate``. Besides, ``collate_icl_batch`` runs the original's
body inside the port's ``port/collate`` span (``utils/perf.py:span``).
The framework-free ``registry``, ``utils.tokenization`` and ``utils.native``
are still imported from the JAX package. Keep the copies in step.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence

import numpy as np

from ..ops.mel import N_SAMPLES
from ..utils.perf import span
from ..utils.tokenization import Tokenizer
from .packing import PackConfig, PackedBatch, PackedSample, pack_batch, shift_labels, tokenize_plan
from .prompts import PromptPlan

logger = logging.getLogger(__name__)


@dataclass
class ICLSample:
    """One ICL item, host-side: the rendered plan plus raw audio per slot."""

    plan: PromptPlan
    completion: str
    #: raw 16 kHz wavs keyed by slot tuple from plan.slots, e.g. ("example", 0)
    slot_audio: Dict[tuple, np.ndarray]
    extras: Dict[str, Any] = None


def collate_icl_batch(
    samples: Sequence[ICLSample],
    tokenizer: Tokenizer,
    pack_cfg: PackConfig,
    include_wavs: bool = True,
    auto_grow: bool = True,
) -> PackedBatch:
    """Build the device batch: packed indices + (B, n_slots, wav) audio block.

    Mel extraction happens on device (ops/mel.log_mel_spectrogram) right before
    the encoder — the host ships raw wavs only.

    ``auto_grow``: an over-budget batch re-buckets to a coarsely grown
    PackConfig (one extra compile) instead of raising PackError — the
    reference simply ran oversized prompts slower; we match that behavior.
    """
    with span("collate"):
        return _collate_icl_batch(samples, tokenizer, pack_cfg, auto_grow)


def _collate_icl_batch(samples: Sequence[ICLSample], tokenizer: Tokenizer,
                       pack_cfg: PackConfig, auto_grow: bool) -> PackedBatch:
    packed_samples: List[PackedSample] = []
    for s in samples:
        ps = tokenize_plan(tokenizer, s.plan, s.completion, extras=s.extras)
        if pack_cfg.audio_len_fn is not None:
            # variable audio positions per clip (Qwen2-Audio semantics):
            # a missing clip pads as 30 s of silence (full budget), like the
            # reference's zero-spectrogram padding
            counts = []
            for slot in s.plan.slots:
                wav = s.slot_audio.get(slot)
                n = N_SAMPLES if wav is None else min(len(wav), N_SAMPLES)
                counts.append(int(pack_cfg.audio_len_fn(n)))
            ps.slot_token_counts = counts
        packed_samples.append(ps)
    if auto_grow:
        from .packing import required_config

        grown = required_config(packed_samples, pack_cfg)
        if grown is not pack_cfg:
            logger.warning(
                "batch exceeds pack budget; re-bucketing text %d→%d seq %d→%d "
                "slots %d→%d (one extra compile)",
                pack_cfg.text_len, grown.text_len, pack_cfg.seq_len,
                grown.seq_len, pack_cfg.max_slots, grown.max_slots,
            )
            pack_cfg = grown
    batch = pack_batch(packed_samples, pack_cfg)

    B = len(samples)
    n_slots = pack_cfg.max_slots
    # flat (B*n_slots) wav list → native block packer (numpy fallback inside)
    flat: List = [None] * (B * n_slots)
    for b, s in enumerate(samples):
        for i, slot in enumerate(s.plan.slots):
            flat[b * n_slots + i] = s.slot_audio.get(slot)
    from ..utils.native import pack_audio_block

    # bucket the transport length to the batch's longest clip (5 s steps): the
    # device pads to 30 s before encoding, so numerics are identical while
    # host→device bytes shrink ~(30s / clip length)
    bucket_step = 5 * 16000
    longest = max((len(w) for w in flat if w is not None), default=bucket_step)
    bucket = min(N_SAMPLES, -(-min(longest, N_SAMPLES) // bucket_step) * bucket_step)
    wavs = pack_audio_block(flat, bucket).reshape(B, n_slots, bucket)
    # ship as int16: halves host->device transfer; device converts back
    # (source audio is 16-bit PCM anyway)
    batch.audio["wavs"] = np.clip(wavs * 32767.0, -32768, 32767).astype(np.int16)
    if pack_cfg.audio_len_fn is not None:
        # valid raw-sample count per slot for the on-device encoder mask
        # (device recomputes frame counts with the same integer formula the
        # packer used for splice counts, so gather and mask always agree)
        lengths = np.full((B, n_slots), N_SAMPLES, np.int32)
        for b, s in enumerate(samples):
            for i, slot in enumerate(s.plan.slots):
                wav = s.slot_audio.get(slot)
                if wav is not None:
                    lengths[b, i] = min(len(wav), N_SAMPLES)
        batch.audio["audio_lengths"] = lengths
    batch.labels_shifted = shift_labels(batch.labels)
    return batch
