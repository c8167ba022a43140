"""Model factory: the SALMONN presets, built from a seed on a device.

Counterpart of ``create_model`` in ``icl_speech_text_llm_tpu/models/factory.py``
for the SALMONN family. Weights are random (no checkpoint is in the
repository), drawn from a ``torch.Generator`` on the target device and
stored in the preset's compute dtype.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import torch

from ..inference.engine import SalmonnEngine
from ..utils.tokenization import Tokenizer, get_tokenizer
from .salmonn import SalmonnConfig, init_salmonn, salmonn_7b, salmonn_13b, salmonn_bench, salmonn_tiny

logger = logging.getLogger(__name__)

SALMONN_PRESETS = {
    "salmonn": salmonn_13b,
    "salmonn-13b": salmonn_13b,
    "salmonn-7b": salmonn_7b,
    "salmonn-tiny": salmonn_tiny,
    "salmonn-bench": salmonn_bench,
}


class SalmonnModel:
    """Config + params + tokenizer + the generation engine."""

    def __init__(self, cfg: SalmonnConfig, params: Dict[str, Any], tokenizer: Tokenizer,
                 generation=None, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.engine = SalmonnEngine(cfg, params, tokenizer, generation, device)


def create_model(model_type: str = "salmonn-tiny", tokenizer: Optional[str] = None,
                 seed: int = 0, generation=None, device="cuda",
                 trainable_dtype=None) -> SalmonnModel:
    """A SALMONN preset with random weights from ``seed`` on ``device``;
    ``trainable_dtype`` (training: f32) stores LoRA and the Q-Former apart
    from the frozen weights' compute dtype."""
    key = model_type.lower()
    if key not in SALMONN_PRESETS:
        raise NotImplementedError(
            f"model type '{model_type}' is not ported; options: {sorted(SALMONN_PRESETS)}")
    cfg = SALMONN_PRESETS[key]()
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_salmonn(cfg, gen, dev, dtype=cfg.compute_dtype,
                          trainable_dtype=trainable_dtype)
    logger.info(f"Created {key} on {dev} (random init, seed {seed})")
    return SalmonnModel(cfg, params, get_tokenizer(tokenizer), generation, dev)
