"""The check that a run loaded no JAX: the top-level name of every module in
``sys.modules`` (the part before the first dot) compared whole against
JAX's libraries and the JAX package, whose name the port's begins with."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "orbax", "icl_speech_text_llm_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)
