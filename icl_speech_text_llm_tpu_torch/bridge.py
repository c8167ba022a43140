"""Weight bridge: a JAX-package parameter tree → the port's tensors.

The port keeps the JAX tree layout (key names, stacked ``(L, ...)`` layer
leaves, LoRA ``{"a", "b"}`` leaves, KV-cache ``{"k", "v"}``), so the bridge
is a name-for-name copy. Leaves may be numpy arrays or anything
``numpy.asarray`` accepts (a JAX array converted by the caller, a memmap).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_numpy(tree: Any, device="cpu", dtype: torch.dtype = torch.float32) -> Any:
    """Copy a nested dict/list/tuple of arrays to torch tensors on ``device``.
    Floating-point leaves are cast to ``dtype``; integer leaves keep theirs."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device, dtype) for v in tree)
    arr = np.ascontiguousarray(np.asarray(tree))
    if not arr.flags.writeable:  # e.g. a JAX array's read-only buffer
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if t.is_floating_point():
        return t.to(device=device, dtype=dtype)
    return t.to(device=device)

