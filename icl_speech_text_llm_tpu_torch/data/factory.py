"""Dataset factory (ref: data/dataset_factory.py:16-268).

Validates input/fewshot modes, loads per-task data (HF on-disk or synthetic),
wires audio lookups, and builds single- or multi-task ICL datasets.

A copy of ``icl_speech_text_llm_tpu/data/factory.py`` with only the
imports changed: every JAX-package ``data`` module imports through
``data/__init__``, whose ``collate`` pulls in jax through ``ops.mel``.
The framework-free ``registry``, ``utils.tokenization`` and ``utils.native``
are still imported from the JAX package. Keep the copies in step.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence, Union

from ..registry import DatasetSplit, DatasetType, get_dataset_config
from .icl_dataset import ICLDataset
from .multitask import MultiTaskICLDataset
from .sources import SyntheticLookup, load_dataset, make_synthetic_dataset

logger = logging.getLogger(__name__)

VALID_INPUT_MODES = ("speech_only", "speech_and_text", "text_only")
VALID_FEWSHOT_MODES = ("text", "speech", "none")


def create_dataset(
    dataset_types: Union[DatasetType, Sequence[DatasetType]],
    split: DatasetSplit = DatasetSplit.TEST,
    input_mode: str = "speech_only",
    fewshot_mode: str = "text",
    num_examples: int = 5,
    random_examples: bool = False,
    randomize_swap: bool = False,
    is_training: bool = False,
    balance_datasets: bool = True,
    interleave: bool = True,
    max_samples: Optional[int] = None,
    synthetic: bool = False,
    synthetic_size: int = 32,
    seed: int = 0,
    prompt_style: str = "salmonn",
):
    """Build an ICLDataset (single task) or MultiTaskICLDataset (several).

    Mode validation mirrors the reference factory (ref: dataset_factory.py:
    44-63); ``synthetic`` swaps the disk loader for schema-correct fabricated
    data (hermetic runs; not in the reference).
    """
    if input_mode not in VALID_INPUT_MODES:
        raise ValueError(f"Invalid input_mode '{input_mode}'; expected {VALID_INPUT_MODES}")
    if fewshot_mode not in VALID_FEWSHOT_MODES:
        raise ValueError(f"Invalid fewshot_mode '{fewshot_mode}'; expected {VALID_FEWSHOT_MODES}")
    if fewshot_mode == "none":
        num_examples = 0
    if num_examples < 0:
        raise ValueError("num_examples must be >= 0")

    if isinstance(dataset_types, DatasetType):
        dataset_types = [dataset_types]

    built: Dict[DatasetType, ICLDataset] = {}
    for dt in dataset_types:
        if synthetic:
            rows = make_synthetic_dataset(dt, n=synthetic_size, seed=seed)
            lookup = SyntheticLookup(dt, n=max(8, synthetic_size // 2), seed=seed + 1)
        else:
            try:
                rows = load_dataset(dt, split)
                lookup = _load_audio_lookup(dt, split)
            except Exception as e:
                # multi-task runs skip datasets that fail to load, matching
                # the reference (ref: orchestrator_training.py:86-88); a
                # single-dataset request still raises.
                if len(dataset_types) > 1:
                    logger.warning(f"skipping dataset {dt.value}: {e}")
                    continue
                raise
        if max_samples:
            rows = rows[:max_samples] if isinstance(rows, list) else rows.select(
                range(min(max_samples, len(rows)))
            )
        built[dt] = ICLDataset(
            dataset_type=dt,
            dataset=rows,
            input_mode=input_mode,
            fewshot_mode=fewshot_mode,
            num_examples=num_examples,
            random_examples=random_examples,
            split=split,
            randomize_swap=randomize_swap,
            audio_lookup=lookup,
            seed=seed,
            prompt_style=prompt_style,
        )

    if not built:
        raise RuntimeError("no datasets could be loaded")
    if len(built) == 1:
        return next(iter(built.values()))
    if is_training:
        return MultiTaskICLDataset(built, balance_datasets, interleave, seed)
    return MultiTaskICLDataset(built, balance_datasets=False, interleave=False, seed=seed)


class _HFLookup:
    """Adapter giving HF lookup datasets the by_index protocol
    (ref index map: data/multi_task_dataset.py:126-129)."""

    def __init__(self, ds):
        self.ds = ds
        self._index_map = None
        if "index" in getattr(ds, "column_names", []):
            self._index_map = {str(v): i for i, v in enumerate(ds["index"])}

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[int(i)]

    def by_index(self, index_str: str):
        if self._index_map is None:
            return None
        i = self._index_map.get(index_str)
        return self.ds[i] if i is not None else None


def _load_audio_lookup(dt: DatasetType, split: DatasetSplit):
    config = get_dataset_config(dt)
    path = config.get_audio_lookup_path(split)
    if not path:
        return None
    try:
        from datasets import load_from_disk

        return _HFLookup(load_from_disk(path))
    except Exception as e:
        logger.warning(f"Audio lookup unavailable for {dt} ({e}); continuing without")
        return None
