"""Core task-catalog types.

Parity surface for the reference's declarative dataset config records
(ref: data/base_config.py:5-66). Unlike the reference, dataset paths are not
hard-coded cluster paths: they resolve through environment variables /
``set_data_root`` so the framework is portable (SURVEY.md §8 item 11).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from enum import Enum
from typing import Dict, List, Optional


class DatasetType(str, Enum):
    """Task identifiers. Values match the reference CLI strings
    (ref: data/base_config.py:5-36)."""

    VOXCELEB = "voxceleb"
    HVB = "hvb"
    VOXPOPULI = "voxpopuli"

    VOXCELEB_GREEK = "voxceleb_greek"
    HVB_GREEK = "hvb_greek"
    VOXPOPULI_GREEK = "voxpopuli_greek"

    VOXCELEB_SWAP = "voxceleb_swap"
    HVB_SWAP = "hvb_swap"
    VOXPOPULI_SWAP = "voxpopuli_swap"

    VOXPOPULI_NEL = "voxpopuli_nel"
    SQA = "sqa"
    VP_NEL = "vp_nel"

    MELD = "meld"
    MELD_GREEK = "meld_greek"
    MELD_EMOTION = "meld_emotion"
    MELD_EMOTION_GREEK = "meld_emotion_greek"
    MELD_EMOTION_SWAP = "meld_emotion_swap"


class DatasetSplit(Enum):
    TRAIN = "train"
    VAL = "validation"
    TEST = "test"


#: Environment variable that points at the root of the on-disk datasets.
DATA_ROOT_ENV = "ICL_TPU_DATA_ROOT"

_DEFAULT_DATA_ROOT = "data"
_data_root_override: Optional[str] = None


def set_data_root(path: str) -> None:
    """Override the dataset root for this process (wins over the env var)."""
    global _data_root_override
    _data_root_override = path


def get_data_root() -> str:
    if _data_root_override is not None:
        return _data_root_override
    return os.environ.get(DATA_ROOT_ENV, _DEFAULT_DATA_ROOT)


@dataclass(frozen=True)
class DatasetConfig:
    """Declarative description of one task variant.

    Mirrors the reference record (ref: data/base_config.py:43-66) with
    relative ``paths`` resolved against :func:`get_data_root`.
    """

    name: DatasetType
    paths: Dict[DatasetSplit, str]
    prompt_template: str
    valid_labels: Optional[List[str]]
    completion_key: str
    text_key: str
    audio_lookup_paths: Optional[Dict[DatasetSplit, str]] = None
    label_mapping: Optional[Dict[str, str]] = None
    additional_text_keys: Optional[Dict[str, str]] = None
    additional_audio_keys: Optional[Dict[str, str]] = None
    additional_metadata_keys: Optional[Dict[str, object]] = None
    output_format: Optional[str] = None

    def get_path(self, split: DatasetSplit) -> str:
        return os.path.join(get_data_root(), self.paths[split])

    def get_audio_lookup_path(self, split: DatasetSplit) -> Optional[str]:
        if self.audio_lookup_paths and split in self.audio_lookup_paths:
            return os.path.join(get_data_root(), self.audio_lookup_paths[split])
        return None

    def with_overrides(self, **kw) -> "DatasetConfig":
        return replace(self, **kw)


def make_swap_variants(
    base: DatasetConfig,
    swap_name: DatasetType,
    permutations: List[List[str]],
    template_fn,
) -> List[DatasetConfig]:
    """Build the family of label-permutation ("swap") task variants.

    Each permutation re-labels ``base.valid_labels`` positionally and re-renders
    the prompt template through ``template_fn(perm)``
    (ref: data/voxceleb_config.py:158-173 et al.).
    """
    variants = []
    for perm in permutations:
        mapping = {orig: swapped for orig, swapped in zip(base.valid_labels, perm)}
        variants.append(
            base.with_overrides(
                name=swap_name,
                prompt_template=template_fn(perm),
                valid_labels=list(perm),
                label_mapping=mapping,
            )
        )
    return variants
