"""Random weights from a family's plan of leaves, drawn from the seed on the
device, one call a leaf, in the type they are served in.

A plan (``benchlib/families/<family>.py``) lists each leaf's path, shape
and init in drawing order: ("normal", std), ("ones",) or ("sinusoids",),
Whisper's position table. Leaves under ``lora`` take the LoRA's type.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sinusoids(length: int, dim: int) -> np.ndarray:
    """Whisper's position table: sin then cos over geometric timescales."""
    inv = np.exp(-np.log(10000.0) / (dim // 2 - 1) * np.arange(dim // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def make(plan: Sequence, seed: int, device, dtype=torch.bfloat16,
         lora_dtype=torch.float32) -> Dict[str, Any]:
    """The weight tree of ``plan`` from ``seed``: ``dtype`` leaves, the LoRA
    in ``lora_dtype``; the same seed on the same device gives the same
    tree."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    tree: Dict[str, Any] = {}
    for path, shape, init in plan:
        dt = lora_dtype if path[0] == "lora" else dtype
        if init[0] == "normal":
            leaf = torch.empty(shape, dtype=dt, device=device).normal_(0.0, init[1],
                                                                     generator=gen)
        elif init[0] == "ones":
            leaf = torch.ones(shape, dtype=dt, device=device)
        else:
            leaf = torch.from_numpy(sinusoids(*shape)).to(device=device, dtype=dt)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree

