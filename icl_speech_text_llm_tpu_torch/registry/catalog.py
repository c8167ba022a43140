"""Master task catalog (ref: data/master_config.py)."""

from typing import Dict, List, Optional

from .base import DatasetConfig, DatasetSplit, DatasetType
from .hvb import HVB_CONFIG, HVB_GREEK_CONFIG, HVB_SWAP_CONFIGS, get_hvb_swap_config
from .meld import (
    MELD_CONFIG,
    MELD_EMOTION_CONFIG,
    MELD_EMOTION_GREEK_CONFIG,
    MELD_EMOTION_SWAP_CONFIGS,
    MELD_GREEK_CONFIG,
    get_meld_emotion_swap_config,
)
from .sqa import SQA_CONFIG
from .voxceleb import (
    VOXCELEB_CONFIG,
    VOXCELEB_GREEK_CONFIG,
    VOXCELEB_SWAP_CONFIGS,
    get_voxceleb_swap_config,
)
from .voxpopuli import (
    VOXPOPULI_CONFIG,
    VOXPOPULI_GREEK_CONFIG,
    VOXPOPULI_SWAP_CONFIGS,
    get_voxpopuli_swap_config,
)
from .vp_nel import VP_NEL_CONFIG

# Swap types resolve to their base config here; the per-item permutation variant
# comes from get_swap_config (ref: data/master_config.py:35-53).
DATASET_CONFIGS: Dict[DatasetType, DatasetConfig] = {
    DatasetType.VOXCELEB: VOXCELEB_CONFIG,
    DatasetType.VOXCELEB_GREEK: VOXCELEB_GREEK_CONFIG,
    DatasetType.HVB: HVB_CONFIG,
    DatasetType.HVB_GREEK: HVB_GREEK_CONFIG,
    DatasetType.VOXPOPULI: VOXPOPULI_CONFIG,
    DatasetType.VOXPOPULI_GREEK: VOXPOPULI_GREEK_CONFIG,
    DatasetType.SQA: SQA_CONFIG,
    DatasetType.VP_NEL: VP_NEL_CONFIG,
    DatasetType.VOXPOPULI_NEL: VP_NEL_CONFIG,
    DatasetType.MELD: MELD_CONFIG,
    DatasetType.MELD_GREEK: MELD_GREEK_CONFIG,
    DatasetType.MELD_EMOTION: MELD_EMOTION_CONFIG,
    DatasetType.MELD_EMOTION_GREEK: MELD_EMOTION_GREEK_CONFIG,
    DatasetType.MELD_EMOTION_SWAP: MELD_EMOTION_CONFIG,
    DatasetType.VOXPOPULI_SWAP: VOXPOPULI_CONFIG,
    DatasetType.VOXCELEB_SWAP: VOXCELEB_CONFIG,
    DatasetType.HVB_SWAP: HVB_CONFIG,
}

SWAP_TYPES = {
    DatasetType.VOXCELEB_SWAP,
    DatasetType.HVB_SWAP,
    DatasetType.VOXPOPULI_SWAP,
    DatasetType.MELD_EMOTION_SWAP,
}


def get_dataset_config(dataset_type: DatasetType) -> Optional[DatasetConfig]:
    """Look up the config for a task (ref: data/master_config.py:55-57)."""
    return DATASET_CONFIGS.get(dataset_type)


def get_swap_config(dataset_type: DatasetType, randomize: bool = False) -> DatasetConfig:
    """Resolve a label-permutation variant (ref: data/master_config.py:59-70)."""
    if dataset_type == DatasetType.VOXCELEB_SWAP:
        return get_voxceleb_swap_config(randomize)
    if dataset_type == DatasetType.HVB_SWAP:
        return get_hvb_swap_config(randomize)
    if dataset_type == DatasetType.VOXPOPULI_SWAP:
        return get_voxpopuli_swap_config(randomize)
    if dataset_type == DatasetType.MELD_EMOTION_SWAP:
        return get_meld_emotion_swap_config(randomize)
    raise ValueError(f"No swap config available for dataset type: {dataset_type}")


def apply_label_mapping(examples: List[dict], label_mapping: Dict[str, str]) -> List[dict]:
    """Re-label raw example dicts in place (ref: data/master_config.py:72-97)."""
    for example in examples:
        if "sentiment" in example:
            if example["sentiment"] in label_mapping:
                example["sentiment"] = label_mapping[example["sentiment"]]
        elif "sentiment_label" in example:
            if example["sentiment_label"] in label_mapping:
                example["sentiment_label"] = label_mapping[example["sentiment_label"]]
        elif "emotion_label" in example:
            if example["emotion_label"] in label_mapping:
                example["emotion_label"] = label_mapping[example["emotion_label"]]
        elif "dialog_acts" in example:
            acts = [a.strip() for a in example["dialog_acts"].split(",")]
            example["dialog_acts"] = ",".join(label_mapping.get(a, a) for a in acts)
        elif "normalized_combined_ner" in example:
            if example["normalized_combined_ner"] in label_mapping:
                example["normalized_combined_ner"] = label_mapping[
                    example["normalized_combined_ner"]
                ]
    return examples


def parse_dataset_types(spec: str) -> List[DatasetType]:
    """Parse a CLI dataset spec; accepts both '-' and ',' separators
    (the reference used '-' in entry points and ',' in factory/README —
    SURVEY.md §8 item 6; we accept both)."""
    sep = "," if "," in spec else "-"
    return [DatasetType(part.strip()) for part in spec.split(sep) if part.strip()]


__all__ = [
    "DatasetType",
    "DatasetSplit",
    "DatasetConfig",
    "DATASET_CONFIGS",
    "SWAP_TYPES",
    "get_dataset_config",
    "get_swap_config",
    "apply_label_mapping",
    "parse_dataset_types",
    "VOXCELEB_SWAP_CONFIGS",
    "HVB_SWAP_CONFIGS",
    "VOXPOPULI_SWAP_CONFIGS",
    "MELD_EMOTION_SWAP_CONFIGS",
]
