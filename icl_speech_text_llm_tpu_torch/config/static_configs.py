"""Static per-model hyperparameter tables.

Parity surface for the reference's config modules
(ref: config/training_config.py:4-72, config/inference_config.py:4-82), with
hardcoded cluster paths replaced by model-preset names and env-resolved roots.
A copy of ``icl_speech_text_llm_tpu/config/static_configs.py`` (it uses no
framework): the code below this docstring is the original's, line for line.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


def get_training_config(
    model_type: str = "salmonn", dataset_type: Optional[str] = None
) -> Dict[str, Any]:
    """(ref: config/training_config.py:4-72)"""
    base = {
        "salmonn": {
            "model_preset": "salmonn-13b",
            "lora_rank": 8,
            "lora_alpha": 32,
            "lora_dropout": 0.05,
            "max_txt_len": 128,
            "learning_rate": 1e-5,
            "weight_decay": 0.01,
            "warmup_steps": 100,
            "scheduler": "linear",
            "precision": "bf16",
        },
        "salmonn-7b": {
            "model_preset": "salmonn-7b",
            "lora_rank": 8,
            "lora_alpha": 32,
            "lora_dropout": 0.05,
            "max_txt_len": 128,
            "learning_rate": 1e-5,
            "weight_decay": 0.01,
            "warmup_steps": 100,
            "scheduler": "linear",
            "precision": "bf16",
        },
        "qwen2": {
            "model_preset": "qwen2-audio-7b",
            "lora_rank": 8,
            "lora_alpha": 32,
            "lora_dropout": 0.1,
            "max_txt_len": 512,
            "learning_rate": 1e-5,
            "weight_decay": 0.01,
            "warmup_steps": 100,
            "scheduler": "linear",
            "precision": "bf16",
        },
        "salmonn-tiny": {
            "model_preset": "salmonn-tiny",
            "lora_rank": 4,
            "lora_alpha": 8,
            "lora_dropout": 0.0,
            "max_txt_len": 128,
            "learning_rate": 1e-3,
            "weight_decay": 0.01,
            "warmup_steps": 10,
            "scheduler": "linear",
            "precision": "f32",
        },
    }
    key = model_type.lower()
    if key not in base:
        raise ValueError(f"Unknown model type: {model_type}")
    cfg = dict(base[key])
    if dataset_type:
        cfg["dataset_type"] = dataset_type
    return cfg


def get_inference_config(
    model_type: str = "salmonn", dataset_type: Optional[str] = None
) -> Dict[str, Any]:
    """Generation defaults (ref: config/inference_config.py:4-82).

    NB: the reference declares do_sample=True/temp=0.7 here but never passes
    them into generate_output — effective behavior is greedy 10-token decode
    (SURVEY.md §8 item 5). We default to the EFFECTIVE behavior.
    """
    cfg = {
        "max_new_tokens": 10,
        "num_beams": 1,
        "do_sample": False,
        "temperature": 0.7,
        "top_p": 0.9,
        "repetition_penalty": 1.0,
        "length_penalty": 1.0,
        "batch_size": 4,
        "model_args": get_training_config(model_type, dataset_type),
    }
    return cfg
