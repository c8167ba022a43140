"""Multi-task model router (ref: models/multi_task_model.py:8-162).

Counterpart of ``icl_speech_text_llm_tpu/models/multi_task.py``, framework-
free: a thin per-task routing over a base model of the port (``SalmonnModel``
or ``QwenAudioModel``). Each task carries its own prompt template and
generation parameters (max_new_tokens, num_beams, do_sample, temperature,
repetition/length penalty, min_new_tokens); forward/generate delegate to the
underlying model, whose engine's ``GenerationConfig`` is replaced for the
active task.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)


class MultiTaskModel:
    def __init__(
        self,
        model,  # SalmonnModel (or any object with forward/generate_output)
        task_configs: Optional[Dict[str, Dict[str, Any]]] = None,
        default_task: Optional[str] = None,
    ):
        self.model = model
        self.task_configs = task_configs or {}
        self.current_task = default_task
        self.task_prompt_templates = {
            task: cfg["prompt_template"]
            for task, cfg in self.task_configs.items()
            if "prompt_template" in cfg
        }
        logger.info(
            f"Initialized MultiTaskModel with {len(self.task_configs)} tasks"
            + (f"; default {default_task}" if default_task else "")
        )

    def set_task(self, task_name: str) -> bool:
        """(ref :52-59)"""
        if task_name in self.task_configs:
            self.current_task = task_name
            logger.info(f"Active task set to: {task_name}")
            return True
        logger.warning(f"Task '{task_name}' not found in configured tasks")
        return False

    def get_task_prompt_template(self, task_name: Optional[str] = None) -> Optional[str]:
        task = task_name or self.current_task
        return self.task_prompt_templates.get(task)

    def get_task_generation_params(self, task_name: Optional[str] = None) -> Dict[str, Any]:
        """Per-task generation params (ref :130-149)."""
        task = task_name or self.current_task
        cfg = self.task_configs.get(task, {})
        return {
            "max_new_tokens": cfg.get("max_new_tokens", 10),
            "num_beams": cfg.get("num_beams", 1),
            "do_sample": cfg.get("do_sample", False),
            "temperature": cfg.get("temperature", 0.8),
            "repetition_penalty": cfg.get("repetition_penalty", 1.0),
            "length_penalty": cfg.get("length_penalty", 1.0),
            "min_new_tokens": cfg.get("min_new_tokens", cfg.get("min_length", 0)),
        }

    def forward(self, samples: Sequence) -> Dict[str, Any]:
        """(ref :68-128) — delegate; per-sample tasks ride in extras."""
        return self.model.forward(samples)

    def generate_output(self, samples: Sequence) -> List[str]:
        """(ref :130-149) — apply the active task's generation params to the
        engine (only when they differ from its current ones)."""
        params = self.get_task_generation_params()
        engine = getattr(self.model, "engine", None)
        if engine is not None:
            from dataclasses import replace

            new_gen = replace(engine.gen, **params)
            if new_gen != engine.gen:
                engine.gen = new_gen
        return self.model.generate_output(samples)
