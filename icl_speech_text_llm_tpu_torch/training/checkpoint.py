"""Trainable-only checkpoints: ``state.npy`` + a ``train_meta.json`` sidecar.

Counterpart of ``icl_speech_text_llm_tpu/training/checkpoint.py`` without
orbax (the machine with the card has none): ``<dir>/state.npy`` is a pickled
dict of numpy arrays ``{"trainable", "step", "opt_state"}`` — the layout the
JAX package's ``load_checkpoint`` falls back to, so either package reads the
other's — and ``train_meta.json`` holds ``epoch``, ``step``, ``loss`` and
``metadata``. Only the trainable subtrees are saved, with the optimizer's
moments for resume; loads are non-strict (unknown subtrees are skipped).
``load_lora_bank`` stacks the ``lora`` subtrees of several checkpoints into
one multi-adapter bank for serving.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .step import tree_leaves, tree_map

logger = logging.getLogger(__name__)


def _to_numpy(tree):
    return tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x,
                    tree)


def save_checkpoint(ckpt_dir: str, trainable: Dict[str, Any], opt_state: Any = None,
                    step: int = 0, epoch: int = 0, loss: float = 0.0,
                    metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write a trainable-only checkpoint; returns its path."""
    path = os.path.abspath(ckpt_dir)
    os.makedirs(path, exist_ok=True)
    state = {"trainable": _to_numpy(trainable), "step": int(step)}
    if opt_state is not None:
        state["opt_state"] = _to_numpy(opt_state)
    np.save(os.path.join(path, "state.npy"), state, allow_pickle=True)
    with open(os.path.join(path, "train_meta.json"), "w") as f:
        json.dump({"epoch": epoch, "step": int(step), "loss": float(loss),
                   "metadata": metadata or {}}, f, indent=2)
    n = sum(int(np.prod(v.shape)) for v in tree_leaves(state["trainable"]))
    logger.info(f"Saved trainable-only checkpoint ({n:,} params) to {path}")
    return path


def load_checkpoint(ckpt_dir: str) -> Dict[str, Any]:
    """A checkpoint dir → {"trainable", "opt_state"?, "step", "meta"?} with
    numpy leaves."""
    path = os.path.abspath(ckpt_dir)
    target = os.path.join(path, "state.npy")
    if not os.path.exists(target):
        raise FileNotFoundError(f"No checkpoint found under {path}")
    state = np.load(target, allow_pickle=True).item()
    meta_path = os.path.join(path, "train_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            state["meta"] = json.load(f)
    return state


def apply_trainable(params: Dict[str, Any], trainable: Dict[str, Any],
                    strict: bool = False) -> Dict[str, Any]:
    """Merge restored trainable subtrees into a full parameter tree.
    Non-strict (default): unknown keys are skipped with a warning."""
    out = dict(params)
    for key, sub in trainable.items():
        if key in out:
            out[key] = sub
        elif strict:
            raise KeyError(f"Checkpoint key {key} not in model params")
        else:
            logger.warning(f"Skipping unknown checkpoint subtree: {key}")
    return out


def copy_into(dst, src) -> None:
    """Copy a numpy tree into a tensor tree of the same structure, in place
    (keeping each tensor's device and dtype)."""
    if isinstance(dst, dict):
        for k, v in dst.items():
            copy_into(v, src[k])
        return
    with torch.no_grad():
        dst.copy_(torch.as_tensor(np.asarray(src)))


def load_lora_bank(ckpt_dirs) -> Dict[str, Any]:
    """Stack the ``lora`` subtrees of N trainable checkpoints into a
    multi-adapter bank (``models/llama.py:stack_lora_bank``; adapter id
    follows list order; CPU tensors, leaves (n_layers, N, ...)). Every
    checkpoint must share rank and targets."""
    if not ckpt_dirs:
        raise ValueError("load_lora_bank needs at least one checkpoint dir")
    from ..models.llama import stack_lora_bank

    adapters = []
    for d in ckpt_dirs:
        trainable = load_checkpoint(d)["trainable"]
        if "lora" not in trainable:
            raise KeyError(f"checkpoint {d} has no 'lora' subtree (keys: {list(trainable)})")
        adapters.append(trainable["lora"])
    return stack_lora_bank(adapters)
