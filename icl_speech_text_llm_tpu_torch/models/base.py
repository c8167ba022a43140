"""BaseModel interface (ref: models/base_model.py:8-143).

Counterpart of ``icl_speech_text_llm_tpu/models/base.py``: the reference
ABC's device and fp16 plumbing (maybe_autocast, .to(device)) is the model
factory's ``device`` and the preset's compute dtype here; what remains is the
interface every model family implements.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List, Sequence


class BaseModel(abc.ABC):
    """Interface: forward → {"loss": ...}; generate_output → List[str];
    get_speech_embeddings → audio positions; from_config classmethod."""

    @abc.abstractmethod
    def forward(self, samples: Sequence) -> Dict[str, Any]:
        """Training forward over ICLSamples (ref :21-36)."""

    @abc.abstractmethod
    def generate_output(self, samples: Sequence) -> List[str]:
        """Batched generation → decoded strings (ref :38-50)."""

    @abc.abstractmethod
    def get_speech_embeddings(self, wavs) -> Any:
        """Raw wavs → LLM-space audio embeddings (ref :52-64)."""

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> "BaseModel":
        """(ref :66-76): dispatch through the factory."""
        from .factory import create_model

        return create_model(**config)
