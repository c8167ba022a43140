"""Multi-task dataset combination (ref: data/multi_task_dataset.py:525-635).

Sampling parity:
- balanced: every task tiled to the largest task's size, round-robin interleave;
- unbalanced + interleaved: round-robin with per-task wraparound;
- sequential: tasks concatenated;
- ``on_epoch_end`` reshuffles per-task index permutations.
Training defaults balanced+interleaved; inference defaults sequential
(ref :619-635).

A copy of ``icl_speech_text_llm_tpu/data/multitask.py`` with only the
imports changed: every JAX-package ``data`` module imports through
``data/__init__``, whose ``collate`` pulls in jax through ``ops.mel``.
The framework-free ``registry``, ``utils.tokenization`` and ``utils.native``
are still imported from the JAX package. Keep the copies in step.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..registry import DatasetType
from .icl_dataset import ICLDataset


class MultiTaskICLDataset:
    def __init__(
        self,
        datasets: Dict[DatasetType, ICLDataset],
        balance_datasets: bool = True,
        interleave: bool = True,
        seed: int = 0,
    ):
        self.datasets = datasets
        self.dataset_types = list(datasets.keys())
        self.balance_datasets = balance_datasets
        self.interleave = interleave
        self._rng = np.random.RandomState(seed)
        self.dataset_sizes = {dt: len(ds) for dt, ds in datasets.items()}

        if balance_datasets:
            self.max_size = max(self.dataset_sizes.values())
            self.total_size = self.max_size * len(self.dataset_types)
            self.dataset_indices = {}
            for dt, size in self.dataset_sizes.items():
                repeats = (self.max_size + size - 1) // size
                idx = np.tile(np.arange(size), repeats)[: self.max_size]
                self._rng.shuffle(idx)
                self.dataset_indices[dt] = idx
        elif interleave:
            self.total_size = sum(self.dataset_sizes.values())
            self.dataset_indices = {}
            for dt, size in self.dataset_sizes.items():
                idx = np.arange(size)
                self._rng.shuffle(idx)
                self.dataset_indices[dt] = idx
        else:
            self.total_size = sum(self.dataset_sizes.values())
            self.index_mapping = [
                (dt, i) for dt in self.dataset_types for i in range(self.dataset_sizes[dt])
            ]

    def __len__(self):
        return self.total_size

    def __getitem__(self, idx: int):
        if self.balance_datasets or self.interleave:
            dt = self.dataset_types[idx % len(self.dataset_types)]
            local = idx // len(self.dataset_types)
            pool = self.dataset_indices[dt]
            item = self.datasets[dt][int(pool[local % len(pool)])]
        else:
            dt, local = self.index_mapping[idx]
            item = self.datasets[dt][int(local)]
        item.extras.setdefault("dataset_type", dt.value)
        return item

    def on_epoch_end(self):
        if self.balance_datasets or self.interleave:
            for idx in self.dataset_indices.values():
                self._rng.shuffle(idx)


def make_training_multitask(datasets, balance=True, interleave=True, seed=0):
    return MultiTaskICLDataset(datasets, balance, interleave, seed)


def make_inference_multitask(datasets, balance=False, interleave=False, seed=0):
    return MultiTaskICLDataset(datasets, balance, interleave, seed)
