"""Data layer: prompt assembly, ICL datasets, fixed-shape packing, collation
(ref layer L3, data/model_processors.py + data/multi_task_dataset.py).

A copy of ``icl_speech_text_llm_tpu/data/__init__.py``, re-exporting the
port's copies of the data modules: every JAX-package ``data`` module imports
through that package's ``data/__init__``, whose ``collate`` pulls in jax
through ``ops.mel``. Keep the copies in step.
"""

from .collate import ICLSample, collate_icl_batch
from .factory import create_dataset
from .icl_dataset import ICLDataset
from .labels import convert_ner_to_dict, format_label
from .multitask import MultiTaskICLDataset
from .packing import (
    IGNORE_INDEX,
    PackConfig,
    PackedBatch,
    PackError,
    pack_batch,
    shift_labels,
    tokenize_plan,
)
from .prompts import PromptPlan, build_default_prompt, build_sqa_prompt, format_prompt
from .sources import clear_dataset_cache, load_dataset, make_synthetic_dataset

__all__ = [
    "ICLSample",
    "collate_icl_batch",
    "create_dataset",
    "ICLDataset",
    "MultiTaskICLDataset",
    "convert_ner_to_dict",
    "format_label",
    "IGNORE_INDEX",
    "PackConfig",
    "PackedBatch",
    "PackError",
    "pack_batch",
    "shift_labels",
    "tokenize_plan",
    "PromptPlan",
    "build_default_prompt",
    "build_sqa_prompt",
    "format_prompt",
    "clear_dataset_cache",
    "load_dataset",
    "make_synthetic_dataset",
]
