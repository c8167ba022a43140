"""Label formatting (ref: data/multi_task_dataset.py:19-44,175-227).

Pure string/dict logic, parity-critical: the formatted completion strings are
both the training targets and the evaluation ground truth.

A copy of ``icl_speech_text_llm_tpu/data/labels.py`` with only the
imports changed: every JAX-package ``data`` module imports through
``data/__init__``, whose ``collate`` pulls in jax through ``ops.mel``.
The framework-free ``registry``, ``utils.tokenization`` and ``utils.native``
are still imported from the JAX package. Keep the copies in step.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..registry import DatasetConfig, DatasetType

_VOXPOPULI_FAMILY = {
    DatasetType.VOXPOPULI,
    DatasetType.VOXPOPULI_SWAP,
    DatasetType.VOXPOPULI_GREEK,
}


def convert_ner_to_dict(text: str, ner_data: Dict) -> Dict[str, List[str]]:
    """start/length NER spans → {tag: [phrases]}, empty phrases dropped
    (ref: data/multi_task_dataset.py:19-44)."""
    result: Dict[str, List[str]] = {}
    for tag, start, length in zip(ner_data["type"], ner_data["start"], ner_data["length"]):
        phrase = text[start : start + length]
        if phrase.strip():
            result.setdefault(tag, []).append(phrase)
    return result


def format_label(
    label,
    dataset_type: DatasetType,
    config: DatasetConfig,
    current_mapping: Optional[Dict[str, str]] = None,
    text: Optional[str] = None,
    is_raw_ner: bool = False,
) -> str:
    """Normalize a raw dataset label into the completion string
    (ref: data/multi_task_dataset.py:175-227).

    Order of operations is parity-relevant: special output formats first, then
    VoxPopuli dict collapse, list join, lowercase, label mapping.
    """
    # special output formats
    if config.output_format == "timestamps_pair":
        return f"{label}"
    if config.output_format == "entity_timestamps":
        if not label:
            return "none"
        spans = [f"{span['label']}: {span['time_span'][0]} {span['time_span'][1]}" for span in label]
        return "; ".join(spans)

    if dataset_type in _VOXPOPULI_FAMILY and isinstance(label, dict):
        if is_raw_ner and "type" in label:
            label = convert_ner_to_dict(text or "", label)
        keys = [k for k, v in label.items() if v]
        label = ", ".join(keys) if keys else "none"

    if isinstance(label, list):
        label = ", ".join(label)

    label = label.lower()

    mapping = current_mapping if current_mapping is not None else config.label_mapping
    if mapping and isinstance(label, str):
        if "," in label:
            parts = [part.strip().lower() for part in label.split(",")]
            label = ", ".join(mapping.get(p, p) for p in parts)
        else:
            label = mapping.get(label.lower(), label.lower())
    return label
