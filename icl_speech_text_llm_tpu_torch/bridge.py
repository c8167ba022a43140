"""Weight bridge: a JAX-package parameter tree → the port's tensors.

The port keeps the JAX tree layout (key names, stacked ``(L, ...)`` layer
leaves, LoRA ``{"a", "b"}`` leaves, quantized ``{"q", "s"}`` /
``{"q4", "s"}`` weights, KV-cache ``{"k", "v"[, "k_s", "v_s"]}``, a
``stack_lora_bank``'s (L, n_adapters, ...) leaves), so the
bridge is a name-for-name copy. Leaves may be numpy arrays or anything
``numpy.asarray`` accepts (a JAX array converted by the caller, a memmap).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

#: scale leaves of a quantized dict: f32 whatever dtype the tree is cast to,
#: as the JAX package always keeps them
_SCALES = ("s", "k_s", "v_s")


def _is_quantized(tree: dict) -> bool:
    return "q" in tree or "q4" in tree or "k_s" in tree


def params_from_numpy(tree: Any, device="cuda", dtype: torch.dtype = torch.float32) -> Any:
    """Copy a nested dict/list/tuple of arrays to torch tensors on ``device``.
    Floating-point leaves are cast to ``dtype``, except the f32 scales of a
    quantized dict; integer leaves keep their type."""
    if isinstance(tree, dict):
        quant = _is_quantized(tree)
        return {k: params_from_numpy(v, device, torch.float32 if quant and k in _SCALES else dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    arr = np.ascontiguousarray(np.asarray(tree))
    if not arr.flags.writeable:  # e.g. a JAX array's read-only buffer
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if t.is_floating_point():
        return t.to(device=device, dtype=dtype)
    return t.to(device=device)
