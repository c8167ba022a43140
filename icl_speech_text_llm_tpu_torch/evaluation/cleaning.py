"""Prediction-string cleaning with reference parity.

A copy of ``icl_speech_text_llm_tpu/evaluation/cleaning.py`` with only the
imports changed: importing that module runs ``evaluation/__init__``, which
pulls in pandas and sklearn through ``metrics``, and the port must import
on a machine without them. Keep the two copies in step.

Behavioral contract from ref: utils/evaluation_utils.py:469-595 (clean_prediction).
The cleaning rules define the task scores, so they are reproduced semantically
exactly (golden-tested against the reference in tests/test_evaluation.py).
"""

from __future__ import annotations

import re
from typing import Optional, Set

from ..registry import DatasetType, get_dataset_config

_SINGLE_LABEL_TYPES = {
    DatasetType.VOXCELEB,
    DatasetType.VOXCELEB_GREEK,
    DatasetType.MELD_EMOTION,
    DatasetType.MELD_EMOTION_GREEK,
}
_MULTI_LABEL_TYPES = {DatasetType.HVB, DatasetType.HVB_GREEK}
_MULTI_LABEL_NONE_TYPES = {DatasetType.VOXPOPULI, DatasetType.VOXPOPULI_GREEK}


def _normalize(prediction: str) -> str:
    """Strip escapes, collapse whitespace, trim stray commas
    (ref: utils/evaluation_utils.py:474-484)."""
    cleaned = prediction.replace("\\", "")
    cleaned = re.sub(r"\s+", " ", cleaned)
    if "\n" in cleaned:
        cleaned = cleaned.split("\n")[0]
    cleaned = re.sub(r",\s*,", ",", cleaned)
    cleaned = re.sub(r",\s*$", "", cleaned)
    cleaned = re.sub(r"^\s*,", "", cleaned)
    return cleaned


def _valid_label_set(dataset_type: Optional[DatasetType]) -> Optional[Set[str]]:
    if dataset_type is None:
        return None
    config = get_dataset_config(dataset_type)
    if config is not None and config.valid_labels:
        return {label.lower() for label in config.valid_labels}
    return None


def _first_valid_word(cleaned: str, valid: Optional[Set[str]]) -> str:
    """Single-label rule: first valid word, else first word
    (ref: utils/evaluation_utils.py:505-519)."""
    words = [w.strip().lower() for w in re.split(r"[^a-zA-Z]", cleaned)]
    words = [w for w in words if w]
    if valid and words:
        for word in words:
            if word in valid:
                return word
        return words[0]
    if words:
        return words[0]
    return cleaned.lower()


def _valid_csv(cleaned: str, valid: Optional[Set[str]]) -> str:
    """Multi-label rule: keep valid comma-separated labels
    (ref: utils/evaluation_utils.py:525-539)."""
    labels = [l.strip().lower() for l in cleaned.split(",")]
    labels = [l for l in labels if l and "(" not in l and l.strip()]
    if valid:
        found = [l for l in labels if l in valid]
        if found:
            return ", ".join(found)
        return cleaned
    return ", ".join(labels) if labels else cleaned


def clean_prediction(prediction: str, dataset_type: Optional[DatasetType] = None) -> str:
    """Clean a raw model output according to the task's expected format."""
    cleaned = _normalize(prediction)
    valid = _valid_label_set(dataset_type)

    if dataset_type in _SINGLE_LABEL_TYPES:
        return _first_valid_word(cleaned, valid)

    if dataset_type in _MULTI_LABEL_TYPES:
        return _valid_csv(cleaned, valid)

    if dataset_type in _MULTI_LABEL_NONE_TYPES:
        # 'none' is always an acceptable answer here
        # (ref: utils/evaluation_utils.py:546-562).
        if cleaned.lower().strip() == "none":
            return "none"
        extended = set(valid) | {"none"} if valid else None
        return _valid_csv(cleaned, extended)

    if dataset_type == DatasetType.SQA:
        # Expect "start_time end_time" (ref: utils/evaluation_utils.py:564-571).
        cleaned = cleaned.strip()
        try:
            start, end = map(float, cleaned.split())
            return f"{start:.2f} {end:.2f}"
        except (ValueError, TypeError):
            return cleaned

    if dataset_type == DatasetType.VOXPOPULI_NEL:
        # Expect "TYPE: start end; ..." (ref: utils/evaluation_utils.py:573-592).
        if cleaned.lower() == "none":
            return "none"
        try:
            cleaned_spans = []
            for span in cleaned.split(";"):
                span = span.strip()
                if ":" in span:
                    entity_type, times = span.split(":", 1)
                    try:
                        start, end = map(float, times.strip().split())
                        cleaned_spans.append(f"{entity_type.strip()}: {start:.2f} {end:.2f}")
                    except (ValueError, TypeError):
                        cleaned_spans.append(span)
            return "; ".join(cleaned_spans)
        except Exception:
            return cleaned

    return cleaned.lower().strip()
