"""Per-task ICL dataset: raw items → ICLSample (plan + completion + audio).

Behavioral rebuild of BaseMultiTaskDataset (ref: data/multi_task_dataset.py:
47-523): few-shot selection, label formatting, prompt building, audio lookup.
Differences from the reference (all deliberate):
- emits structured ICLSample (PromptPlan + slot audio) instead of tensors —
  tensorization happens in the fixed-shape packer;
- ``random_examples`` is honored if requested (the reference force-disables
  it at :86-87 — we keep the same default OFF);
- swap permutation refresh per item preserved (ref :230-231).

A copy of ``icl_speech_text_llm_tpu/data/icl_dataset.py`` with only the
imports changed: every JAX-package ``data`` module imports through
``data/__init__``, whose ``collate`` pulls in jax through ``ops.mel``.
The framework-free ``registry``, ``utils.tokenization`` and ``utils.native``
are still imported from the JAX package. Keep the copies in step.
"""

from __future__ import annotations

import logging
import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from icl_speech_text_llm_tpu.registry import (
    SWAP_TYPES,
    DatasetConfig,
    DatasetSplit,
    DatasetType,
    get_dataset_config,
    get_swap_config,
)
from .collate import ICLSample
from .labels import format_label
from .prompts import build_default_prompt, build_qwen_prompt, build_sqa_prompt

logger = logging.getLogger(__name__)

#: Tasks whose exemplars come from random draws over the audio lookup instead
#: of the item's retrieval-ranked few_shot_examples (ref :108-120,353-363).
_LOOKUP_SAMPLED = {
    DatasetType.SQA,
    DatasetType.VOXPOPULI_NEL,
    DatasetType.VP_NEL,
    DatasetType.MELD,
    DatasetType.MELD_GREEK,
}


class ICLDataset:
    """One task's examples, rendered into ICL samples."""

    def __init__(
        self,
        dataset_type: DatasetType,
        dataset: Sequence[Dict[str, Any]],
        input_mode: str = "speech_only",
        fewshot_mode: str = "text",
        num_examples: int = 5,
        random_examples: bool = False,
        split: DatasetSplit = DatasetSplit.TEST,
        randomize_swap: bool = False,
        audio_lookup=None,
        seed: int = 0,
        prompt_style: str = "salmonn",  # "salmonn" | "qwen" (ref get_processor)
    ):
        self.dataset_type = dataset_type
        self.dataset = dataset
        self.input_mode = input_mode
        self.fewshot_mode = fewshot_mode
        self.num_examples = num_examples
        self.random_examples = random_examples
        self.split = split
        self.randomize_swap = randomize_swap
        self.audio_lookup = audio_lookup
        self.prompt_style = prompt_style
        self.config = get_dataset_config(dataset_type)
        self.is_swap = dataset_type in SWAP_TYPES
        self.current_config: DatasetConfig = (
            get_swap_config(dataset_type, randomize_swap) if self.is_swap else self.config
        )
        self._rng = random.Random(seed)

    def __len__(self):
        return len(self.dataset)

    # ------------------------------------------------------------------
    def _select_count(self) -> int:
        """How many exemplars (ref :160-173: random 0..k when random_examples)."""
        if self.random_examples:
            return self._rng.randint(0, self.num_examples)
        return self.num_examples

    def _audio_array(self, maybe_audio) -> Optional[np.ndarray]:
        if maybe_audio is None:
            return None
        if isinstance(maybe_audio, dict):
            arr = maybe_audio.get("array")
        else:
            arr = maybe_audio
        if arr is None:
            return None
        return np.asarray(arr, dtype=np.float32)

    def _fewshot_from_item(self, item) -> List[Dict[str, Any]]:
        """First-k retrieval-ranked exemplars (ref :400-412)."""
        few = item.get("few_shot_examples", [])[: self._select_count()]
        out = []
        for ex in few:
            out.append(
                {
                    "text": ex["text"],
                    "label": format_label(
                        ex["label"], self.dataset_type, self.current_config,
                        current_mapping=self.current_config.label_mapping,
                    ),
                    "index": ex.get("index"),
                }
            )
        return out

    def _fewshot_from_lookup(self, text_key: str, completion_key: str) -> List[Dict[str, Any]]:
        """Random draws from the audio lookup (ref :364-398)."""
        if self.audio_lookup is None or len(self.audio_lookup) == 0:
            return []
        count = min(self._select_count(), len(self.audio_lookup))
        idxs = self._rng.sample(range(len(self.audio_lookup)), count)
        out = []
        for i in idxs:
            ex = self.audio_lookup[i]
            out.append(
                {
                    "text": ex[text_key],
                    "label": format_label(
                        ex[completion_key], self.dataset_type, self.current_config,
                        current_mapping=self.current_config.label_mapping,
                        text=ex.get(text_key), is_raw_ner=True,
                    ),
                    "raw": ex,
                }
            )
        return out

    # ------------------------------------------------------------------
    def __getitem__(self, idx: int) -> ICLSample:
        if self.is_swap:
            self.current_config = get_swap_config(self.dataset_type, self.randomize_swap)
        item = self.dataset[idx]
        if self.dataset_type == DatasetType.SQA:
            return self._sqa_item(item)
        return self._default_item(item)

    def _default_item(self, item) -> ICLSample:
        cfg = self.current_config
        use_lookup = self.dataset_type in _LOOKUP_SAMPLED and self.audio_lookup is not None
        if use_lookup and self.num_examples > 0:
            examples = self._fewshot_from_lookup(cfg.text_key, cfg.completion_key)
        else:
            examples = self._fewshot_from_item(item)

        if self.prompt_style == "qwen":
            plan = build_qwen_prompt(
                cfg.prompt_template, item[cfg.text_key], examples,
                input_mode=self.input_mode, fewshot_mode=self.fewshot_mode,
            )
        else:
            plan = build_default_prompt(
                cfg.prompt_template,
                item[cfg.text_key],
                examples,
                input_mode=self.input_mode,
                fewshot_mode=self.fewshot_mode,
            )

        slot_audio: Dict[tuple, np.ndarray] = {}
        for slot in plan.slots:
            kind, i = slot
            if kind == "main":
                if "speech" in self.input_mode:
                    slot_audio[slot] = self._audio_array(item.get("audio"))
            elif kind == "example" and i < len(examples):
                ex = examples[i]
                if "raw" in ex:
                    slot_audio[slot] = self._audio_array(ex["raw"].get("audio"))
                elif ex.get("index") is not None and self.audio_lookup is not None:
                    hit = self.audio_lookup.by_index(str(ex["index"])) if hasattr(
                        self.audio_lookup, "by_index"
                    ) else None
                    if hit is not None:
                        slot_audio[slot] = self._audio_array(hit.get("audio"))

        completion = format_label(
            item[cfg.completion_key], self.dataset_type, cfg,
            current_mapping=cfg.label_mapping, text=item.get(cfg.text_key),
            is_raw_ner=True,
        )
        return ICLSample(
            plan=plan, completion=completion, slot_audio=slot_audio,
            extras={"text": item.get(cfg.text_key, ""),
                    "dataset_type": self.dataset_type.value},
        )

    def _sqa_item(self, item) -> ICLSample:
        cfg = self.current_config
        q_key = cfg.additional_text_keys["question"]
        examples = []
        if self.audio_lookup is not None and self.num_examples > 0:
            count = min(self._select_count(), len(self.audio_lookup))
            for i in self._rng.sample(range(len(self.audio_lookup)), count):
                ex = self.audio_lookup[i]
                examples.append(
                    {
                        "question": ex[q_key],
                        "document": ex[cfg.text_key],
                        "completion": format_label(
                            ex[cfg.completion_key], self.dataset_type, cfg,
                            current_mapping=cfg.label_mapping,
                        ),
                        "raw": ex,
                    }
                )

        if self.prompt_style == "qwen":
            from icl_speech_text_llm_tpu.registry import DatasetType as _DT

            plan = build_qwen_prompt(
                cfg.prompt_template, item[cfg.text_key], examples,
                input_mode=self.input_mode, fewshot_mode=self.fewshot_mode,
                dataset_type=_DT.SQA, question=item[q_key],
            )
        else:
            plan = build_sqa_prompt(
                cfg.prompt_template, item[cfg.text_key], item[q_key], examples,
                input_mode=self.input_mode, fewshot_mode=self.fewshot_mode,
            )
        slot_audio: Dict[tuple, np.ndarray] = {}
        for slot in plan.slots:
            kind, i = slot
            if i == -1:  # main doc/question audio
                key = "document_audio" if kind == "document" else "question_audio"
                slot_audio[slot] = self._audio_array(item.get(key))
            elif i < len(examples):
                raw = examples[i].get("raw", {})
                key = "document_audio" if kind == "document" else "question_audio"
                slot_audio[slot] = self._audio_array(raw.get(key))

        completion = format_label(
            item[cfg.completion_key], self.dataset_type, cfg,
            current_mapping=cfg.label_mapping,
        )
        return ICLSample(
            plan=plan, completion=completion, slot_audio=slot_audio,
            extras={"text": item.get(cfg.text_key, ""),
                    "question": item.get(q_key, ""),
                    "unique_id": item.get("unique_id", ""),
                    "dataset_type": self.dataset_type.value},
        )
