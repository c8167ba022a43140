"""Streaming checkpoint conversion for 13B-scale weights, in numpy.

Counterpart of ``icl_speech_text_llm_tpu/models/stream_convert.py``, which
writes the same directories byte for byte; safetensors files are read by the
port's own numpy reader (``utils/safetensors_np.py``), so no ``safetensors``
package is needed.

- ``TensorSource`` reads ONE tensor at a time from an HF sharded-safetensors
  checkpoint (``model.safetensors.index.json``), a directory of
  ``.safetensors`` files, a single ``.safetensors`` file, or a torch
  ``.pth``/``.bin`` (memory-mapped where the format allows);
- ``stream_decoder_to_dir`` walks the decoder layer by layer, optionally
  quantizing each weight on the fly, and writes every stacked parameter into
  an on-disk ``.npy`` memmap: peak host memory stays about one layer;
- ``load_params_dir`` memory-maps the converted directory back into a
  parameter tree, ``iter_params_dir`` yields its leaves one at a time.

Output layout: ``<dst>/manifest.json`` (tree paths, dtype, shape) plus one
``.npy`` per tensor, path-encoded (``layers.attn.wq.q.npy``).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from ..utils.safetensors_np import SafetensorsFile

logger = logging.getLogger(__name__)

INDEX_NAME = "model.safetensors.index.json"

#: keys a torch checkpoint may nest its state dict under
WRAPPER_KEYS = ("model", "state_dict", "model_state_dict", "ckpt")


def unwrap_state_dict(obj):
    """The state dict inside a loaded torch checkpoint: the first of
    ``WRAPPER_KEYS`` that holds a dict, else the object itself."""
    if isinstance(obj, dict):
        for key in WRAPPER_KEYS:
            if key in obj and isinstance(obj[key], dict):
                return obj[key]
    return obj


class TensorSource:
    """Lazy one-tensor-at-a-time reader over checkpoint files."""

    def __init__(self, path: str):
        self.path = path
        self._files: Dict[str, str] = {}  # tensor name → file
        self._handles: Dict[str, SafetensorsFile] = {}
        self._torch_sd = None
        if os.path.isdir(path):
            index = os.path.join(path, INDEX_NAME)
            if os.path.exists(index):
                with open(index) as f:
                    weight_map = json.load(f)["weight_map"]
                self._files = {k: os.path.join(path, v) for k, v in weight_map.items()}
            else:
                # un-indexed dir: every .safetensors file inside
                for fn in sorted(os.listdir(path)):
                    if fn.endswith(".safetensors"):
                        full = os.path.join(path, fn)
                        for k in self._open(full).keys():
                            self._files[k] = full
        elif path.endswith(".safetensors"):
            for k in self._open(path).keys():
                self._files[k] = path
        else:
            # torch pickle: mmap=True avoids a full copy for zipfile-format
            # checkpoints; tensors materialize one at a time in .get()
            import torch

            try:
                obj = torch.load(path, map_location="cpu", mmap=True, weights_only=False)
            except RuntimeError:  # a legacy (non-zipfile) pickle cannot be mapped
                obj = torch.load(path, map_location="cpu", weights_only=False)
            self._torch_sd = unwrap_state_dict(obj)

    def _open(self, fn: str) -> SafetensorsFile:
        if fn not in self._handles:
            self._handles[fn] = SafetensorsFile(fn)
        return self._handles[fn]

    def keys(self):
        if self._torch_sd is not None:
            return list(self._torch_sd.keys())
        return list(self._files.keys())

    def __contains__(self, name: str) -> bool:
        return name in (self._torch_sd if self._torch_sd is not None else self._files)

    def get(self, name: str) -> np.ndarray:
        """Load one tensor as numpy (f32 for float types)."""
        if self._torch_sd is not None:
            t = self._torch_sd[name]
            if hasattr(t, "float"):
                t = t.detach()
                if t.dtype.is_floating_point:
                    t = t.float()
                return t.numpy()
            return np.asarray(t)
        arr = self._open(self._files[name]).get_tensor(name)
        if arr.dtype in (np.float16, np.float64) or arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        return arr


def _quantize_np(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8 (matches ops/quant.quantize_tensor)."""
    s = np.abs(w).max(axis=-2) / 127.0
    s = np.where(s == 0.0, 1.0, s).astype(np.float32)
    q = np.clip(np.round(w / s[..., None, :]), -127, 127).astype(np.int8)
    return q, s


def _quantize_np_int4(w: np.ndarray, group: int = 128) -> Tuple[np.ndarray, np.ndarray]:
    """Split-half packed group-wise int4 (matches ops/quant.quantize_tensor_int4)."""
    d_in, d_out = w.shape
    wg = w.reshape(d_in // group, group, d_out)
    s = np.abs(wg).max(axis=-2) / 7.0
    s = np.where(s == 0.0, 1.0, s).astype(np.float32)
    q = np.clip(np.round(wg / s[:, None, :]), -7, 7).astype(np.int8).reshape(d_in, d_out)
    n = (q + 8).astype(np.uint8)
    half = d_in // 2
    return (n[:half] | (n[half:] << 4)), s


def _int4_ok(w: np.ndarray, group: int = 128) -> bool:
    d_in = w.shape[-2]
    return w.ndim == 2 and d_in % 2 == 0 and (d_in // 2) % group == 0


class _DirWriter:
    """Writes tensors (or per-layer slices of stacked tensors) into .npy
    memmaps under dst; tracks the manifest."""

    def __init__(self, dst: str):
        self.dst = dst
        os.makedirs(dst, exist_ok=True)
        self.manifest: Dict[str, Dict[str, Any]] = {}
        self._maps: Dict[str, np.memmap] = {}

    def _open(self, tree_path: str, shape, dtype) -> np.memmap:
        if tree_path not in self._maps:
            fn = tree_path.replace("/", ".") + ".npy"
            self._maps[tree_path] = np.lib.format.open_memmap(
                os.path.join(self.dst, fn), mode="w+", dtype=dtype, shape=tuple(shape))
            self.manifest[tree_path] = {
                "file": fn, "dtype": np.dtype(dtype).name, "shape": list(shape)}
        return self._maps[tree_path]

    def put(self, tree_path: str, value: np.ndarray):
        m = self._open(tree_path, value.shape, value.dtype)
        m[...] = value

    def put_layer(self, tree_path: str, layer: int, n_layers: int, value: np.ndarray):
        m = self._open(tree_path, (n_layers, *value.shape), value.dtype)
        m[layer] = value

    def close(self):
        for m in self._maps.values():
            m.flush()
        self._maps.clear()
        with open(os.path.join(self.dst, "manifest.json"), "w") as f:
            json.dump(self.manifest, f, indent=1, sort_keys=True)


# decoder layer mapping: tree path → (HF suffix, transpose?)
_LAYER_MAP = [
    ("layers/attn/wq", "self_attn.q_proj.weight", True),
    ("layers/attn/wk", "self_attn.k_proj.weight", True),
    ("layers/attn/wv", "self_attn.v_proj.weight", True),
    ("layers/attn/wo", "self_attn.o_proj.weight", True),
    ("layers/mlp/w_gate", "mlp.gate_proj.weight", True),
    ("layers/mlp/w_up", "mlp.up_proj.weight", True),
    ("layers/mlp/w_down", "mlp.down_proj.weight", True),
    ("layers/ln_attn", "input_layernorm.weight", False),
    ("layers/ln_mlp", "post_attention_layernorm.weight", False),
]
_LAYER_BIAS_MAP = [
    ("layers/attn/bq", "self_attn.q_proj.bias"),
    ("layers/attn/bk", "self_attn.k_proj.bias"),
    ("layers/attn/bv", "self_attn.v_proj.bias"),
]
_QUANT_PATHS = {
    "layers/attn/wq", "layers/attn/wk", "layers/attn/wv", "layers/attn/wo",
    "layers/mlp/w_gate", "layers/mlp/w_up", "layers/mlp/w_down", "lm_head",
}


def stream_decoder_to_dir(
    src: TensorSource,
    cfg,  # DecoderConfig
    dst: str,
    prefix: str = "model.",
    quantize=False,  # False | True/"int8" | "int4"
    dtype: str = "float32",
) -> Dict[str, Any]:
    """HF LLaMA/Qwen2 decoder → on-disk param dir, one layer resident at a
    time. Returns the manifest. ``quantize`` stores matmul weights in the
    serving layout of ops/quant.quantize_decoder: ``"int8"``/True → per-column
    int8 ``{q, s}``; ``"int4"`` → split-half packed group-128 ``{q4, s}``
    (the lm_head stays int8, as quantize_decoder keeps it; tensors whose input
    dim is int4-incompatible fall back to int8)."""
    out_dtype = np.dtype(dtype)
    mode = {True: "int8", False: None}.get(quantize, quantize)
    writer = _DirWriter(dst)

    def g(name: str) -> np.ndarray:
        for cand in (prefix + name, name):
            if cand in src:
                return src.get(cand)
        raise KeyError(f"missing weight: {prefix + name}")

    def emit(tree_path: str, w: np.ndarray, layer: Optional[int] = None):
        if mode and tree_path in _QUANT_PATHS:
            if mode == "int4" and tree_path != "lm_head" and _int4_ok(w):
                q4, s = _quantize_np_int4(w)
                pairs = [(tree_path + "/q4", q4), (tree_path + "/s", s)]
            else:
                q, s = _quantize_np(w)
                pairs = [(tree_path + "/q", q), (tree_path + "/s", s)]
        else:
            pairs = [(tree_path, w.astype(out_dtype) if w.dtype.kind == "f" else w)]
        for p, v in pairs:
            if layer is None:
                writer.put(p, v)
            else:
                writer.put_layer(p, layer, cfg.n_layers, v)

    for i in range(cfg.n_layers):
        hf_prefix = f"layers.{i}."
        for tree_path, suffix, transpose in _LAYER_MAP:
            w = g(hf_prefix + suffix)
            emit(tree_path, np.ascontiguousarray(w.T) if transpose else w, layer=i)
        if cfg.qkv_bias:
            for tree_path, suffix in _LAYER_BIAS_MAP:
                emit(tree_path, g(hf_prefix + suffix), layer=i)
        logger.info("converted layer %d/%d", i + 1, cfg.n_layers)

    emit("tok_embed", g("embed_tokens.weight"))
    emit("final_norm", g("norm.weight"))
    if not cfg.tie_embeddings:
        if "lm_head.weight" not in src:
            raise KeyError("missing weight: lm_head.weight")
        emit("lm_head", np.ascontiguousarray(src.get("lm_head.weight").T))
    writer.close()
    return writer.manifest


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict → {slash-joined tree path: leaf}, the manifest's paths."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(flatten_tree(v, path) if isinstance(v, dict) else {path: v})
    return out


def load_params_dir(path: str, mmap: bool = True) -> Dict[str, Any]:
    """Converted param dir → nested numpy tree (memory-mapped by default, so
    each leaf is read from disk only when it is copied to the device)."""
    tree: Dict[str, Any] = {}
    for tree_path, arr in iter_params_dir(path, mmap):
        node = tree
        parts = tree_path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def iter_params_dir(path: str, mmap: bool = True) -> Iterator[Tuple[str, np.ndarray]]:
    """Yield (tree_path, array) one at a time, in the manifest's order."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    for tree_path, meta in manifest.items():
        yield tree_path, np.load(os.path.join(path, meta["file"]),
                                 mmap_mode="r" if mmap else None)
