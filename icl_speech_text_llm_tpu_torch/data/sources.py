"""Dataset sources: HF save_to_disk loading with cache, plus a synthetic
generator for hermetic runs.

``load_dataset`` mirrors the reference's loader (ref: utils/data_utils.py:
22-95): greek/swap variants resolve to their base dataset's files, loads are
cached in-process. The synthetic source fabricates schema-correct items per
task so every pipeline (and the benchmark) runs without the SLUE corpora.

A copy of ``icl_speech_text_llm_tpu/data/sources.py`` with only the
imports changed: every JAX-package ``data`` module imports through
``data/__init__``, whose ``collate`` pulls in jax through ``ops.mel``.
The framework-free ``registry``, ``utils.tokenization`` and ``utils.native``
are still imported from the JAX package. Keep the copies in step.
"""

from __future__ import annotations

import logging
import random
from typing import Any, Dict, List, Optional

import numpy as np

from icl_speech_text_llm_tpu.registry import DatasetSplit, DatasetType, get_dataset_config

logger = logging.getLogger(__name__)

_DATASET_CACHE: Dict[str, Any] = {}

#: greek/swap variants read the base dataset's files
#: (ref: utils/data_utils.py:34-55)
_BASE_TYPE = {
    DatasetType.VOXCELEB_GREEK: DatasetType.VOXCELEB,
    DatasetType.VOXCELEB_SWAP: DatasetType.VOXCELEB,
    DatasetType.HVB_GREEK: DatasetType.HVB,
    DatasetType.HVB_SWAP: DatasetType.HVB,
    DatasetType.VOXPOPULI_GREEK: DatasetType.VOXPOPULI,
    DatasetType.VOXPOPULI_SWAP: DatasetType.VOXPOPULI,
    DatasetType.MELD_GREEK: DatasetType.MELD,
    DatasetType.MELD_EMOTION_GREEK: DatasetType.MELD_EMOTION,
    DatasetType.MELD_EMOTION_SWAP: DatasetType.MELD_EMOTION,
}


def resolve_base_type(dataset_type: DatasetType) -> DatasetType:
    return _BASE_TYPE.get(dataset_type, dataset_type)


def load_dataset(
    dataset_type: DatasetType, split: DatasetSplit, use_cache: bool = True
):
    """Load the HF ``save_to_disk`` dataset for a task/split (cached)."""
    base = resolve_base_type(dataset_type)
    config = get_dataset_config(base)
    path = config.get_path(split)
    key = f"{base.value}:{split.value}:{path}"
    if use_cache and key in _DATASET_CACHE:
        return _DATASET_CACHE[key]

    from datasets import load_from_disk

    ds = load_from_disk(path)
    if use_cache:
        _DATASET_CACHE[key] = ds
    logger.info(f"Loaded {base.value} {split.value} from {path}: {len(ds)} rows")
    return ds


def clear_dataset_cache() -> int:
    """(ref: utils/data_utils.py:95-110)"""
    n = len(_DATASET_CACHE)
    _DATASET_CACHE.clear()
    logger.info(f"Dataset cache cleared: {n} datasets")
    return n


def get_dataset_sample(
    dataset_type: DatasetType, split: DatasetSplit = DatasetSplit.TRAIN,
    n_samples: int = 5, seed: Optional[int] = None,
):
    """Random sample for inspection (ref: utils/data_utils.py:112-141)."""
    data = load_dataset(dataset_type, split)
    rng = random.Random(seed)
    if len(data) <= n_samples:
        return list(data)
    idxs = rng.sample(range(len(data)), n_samples)
    return [data[i] for i in idxs]


def get_dataset_stats(dataset_type: DatasetType, split: DatasetSplit = DatasetSplit.TRAIN):
    """Size + label distribution (ref: utils/data_utils.py:143-185)."""
    data = load_dataset(dataset_type, split)
    config = get_dataset_config(resolve_base_type(dataset_type))
    stats = {"dataset_type": dataset_type.value, "split": split.value,
             "num_examples": len(data)}
    if config and config.completion_key:
        label_counts: Dict[str, int] = {}
        for item in data:
            label = item.get(config.completion_key)
            key = str(label)
            label_counts[key] = label_counts.get(key, 0) + 1
        stats["label_distribution"] = label_counts
    return stats


def validate_dataset(dataset_type: DatasetType, split: DatasetSplit = DatasetSplit.TRAIN):
    """Field presence check (ref: utils/data_utils.py:187-236)."""
    data = load_dataset(dataset_type, split)
    config = get_dataset_config(resolve_base_type(dataset_type))
    required = [config.completion_key, config.text_key]
    missing: Dict[str, list] = {}
    for idx, item in enumerate(data):
        for field in required:
            if field not in item:
                missing.setdefault(field, []).append(idx)
    return {
        "dataset_type": dataset_type.value,
        "split": split.value,
        "num_examples": len(data),
        "missing_fields": missing,
        "is_valid": not missing,
    }


# ---------------------------------------------------------------------------
# Synthetic data
# ---------------------------------------------------------------------------

_SENTIMENT_TEXTS = {
    "positive": ["what a wonderful day", "i really love this", "that was fantastic news"],
    "negative": ["this is terrible", "i am so disappointed", "what an awful experience"],
    "neutral": ["the meeting is at noon", "it is a table", "the report has ten pages"],
}


def _tone(rng: np.random.RandomState, seconds: float = 2.0, freq: float = 300.0):
    t = np.arange(int(16000 * seconds)) / 16000.0
    return (0.1 * np.sin(2 * np.pi * freq * t) + 0.01 * rng.randn(len(t))).astype(np.float32)


def make_synthetic_dataset(
    dataset_type: DatasetType,
    n: int = 32,
    k_fewshot: int = 10,
    seed: int = 0,
    with_audio: bool = True,
) -> List[Dict[str, Any]]:
    """Fabricate n schema-correct items for a task, mirroring the on-disk
    layout the reference consumes (few_shot_examples, audio dicts, NER spans)."""
    base = resolve_base_type(dataset_type)
    config = get_dataset_config(base)
    rng = np.random.RandomState(seed)
    labels = config.valid_labels or []
    items = []
    for i in range(n):
        if base in (DatasetType.VOXCELEB, DatasetType.MELD, DatasetType.MELD_EMOTION):
            label = labels[i % len(labels)]
            texts = _SENTIMENT_TEXTS.get(label, [f"synthetic utterance {i}"])
            item = {
                config.text_key: texts[i % len(texts)] + f" number {i}",
                config.completion_key: label,
            }
        elif base == DatasetType.HVB:
            acts = [labels[i % len(labels)], labels[(i + 7) % len(labels)]]
            item = {config.text_key: f"banking statement {i}",
                    config.completion_key: ",".join(sorted(set(acts)))}
        elif base == DatasetType.VOXPOPULI:
            tag = labels[i % len(labels)].upper()
            text = f"the parliament decision {i} in brussels"
            # main items carry raw start/length NER spans like the real corpus
            # (converted via convert_ner_to_dict at item time)
            ner = (
                {"type": [tag], "start": [4], "length": [10]}
                if i % 3
                else {"type": [], "start": [], "length": []}
            )
            item = {config.text_key: text, config.completion_key: ner}
        elif base == DatasetType.SQA:
            item = {
                config.text_key: f"the document says the answer is item {i}",
                "normalized_question_text": f"what is item {i}",
                config.completion_key: f"item {i}",
                "unique_id": f"sqa-{i}",
                "question_id": f"q-{i}",
                "document_id": f"d-{i}",
            }
            if with_audio:
                item["question_audio"] = {"array": _tone(rng, 1.0, 260.0 + i)}
                item["document_audio"] = {"array": _tone(rng, 2.0, 200.0 + i)}
        elif base in (DatasetType.VP_NEL, DatasetType.VOXPOPULI_NEL):
            spans = (
                [{"label": "PLACE", "time_span": [0.5 + i * 0.01, 1.2 + i * 0.01]}]
                if i % 2
                else []
            )
            item = {
                config.text_key: f"spoken sentence {i}",
                config.completion_key: spans,
                "unique_id": f"nel-{i}",
                "speaker_id": f"spk-{i % 4}",
            }
        else:
            item = {config.text_key: f"utterance {i}", config.completion_key: "unknown"}

        if with_audio and "audio" not in item and base != DatasetType.SQA:
            item["audio"] = {"array": _tone(rng, 1.0 + (i % 3), 220.0 + 20 * i)}
        # retrieval-ranked fewshot candidates (ref datasets are *_embedding_topk10)
        few = []
        for j in range(k_fewshot):
            fl = labels[(i + j + 1) % len(labels)] if labels else f"answer {j}"
            few.append({"text": f"fewshot text {i}-{j}", "label": fl, "index": str((i + j) % n)})
        item["few_shot_examples"] = few
        item["index"] = str(i)
        items.append(item)
    return items


class SyntheticLookup:
    """Audio-lookup stand-in: index → {'audio': {'array': wav}} plus raw fields
    (the reference random-samples exemplars from lookup datasets for
    SQA/VP-NEL/MELD — ref: data/multi_task_dataset.py:345-398)."""

    def __init__(self, dataset_type: DatasetType, n: int = 16, seed: int = 1):
        self.items = make_synthetic_dataset(dataset_type, n=n, seed=seed)
        self._index_map = {item["index"]: i for i, item in enumerate(self.items)}

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def by_index(self, index_str: str):
        i = self._index_map.get(index_str)
        return self.items[i] if i is not None else None
