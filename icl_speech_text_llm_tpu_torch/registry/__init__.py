"""Declarative task catalog: dataset types, prompt templates, label spaces,
greek/swap variants (ref layer L1, data/*_config.py).

A copy of ``icl_speech_text_llm_tpu/registry`` so that the port imports
nothing of the JAX package; its ``DatasetType`` is a class of its own
(compare members across the two packages by ``.value``)."""

from .base import (
    DATA_ROOT_ENV,
    DatasetConfig,
    DatasetSplit,
    DatasetType,
    get_data_root,
    set_data_root,
)
from .catalog import (
    DATASET_CONFIGS,
    SWAP_TYPES,
    apply_label_mapping,
    get_dataset_config,
    get_swap_config,
    parse_dataset_types,
)

__all__ = [
    "DATA_ROOT_ENV",
    "DatasetConfig",
    "DatasetSplit",
    "DatasetType",
    "get_data_root",
    "set_data_root",
    "DATASET_CONFIGS",
    "SWAP_TYPES",
    "apply_label_mapping",
    "get_dataset_config",
    "get_swap_config",
    "parse_dataset_types",
]
