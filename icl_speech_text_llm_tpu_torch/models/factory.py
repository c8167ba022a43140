"""Model factory + the high-level model wrapper: the SALMONN presets, built
from a seed on a device, with converted weights loaded in place of the
random ones where given.

Counterpart of ``icl_speech_text_llm_tpu/models/factory.py`` for the SALMONN
family (ref: models/model_factory.py:29-386, models/base_model.py:8-143):
``create_model``, ``from_config``, ``get_model_from_checkpoint``;
``SalmonnModel`` exposes ``forward(samples) → {"loss": ...}``,
``generate_output(samples) → [str]``, ``get_speech_embeddings`` and
``load_trainable``. Random weights are drawn from a ``torch.Generator`` on
the target device and stored in the preset's compute dtype. Qwen2-Audio is
not ported yet.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..bridge import params_from_numpy
from ..data.collate import ICLSample, collate_icl_batch
from ..data.packing import PackConfig
from ..inference.engine import SalmonnEngine
from ..ops.mel import log_mel_spectrogram
from ..training.checkpoint import apply_trainable, load_checkpoint
from ..utils.tokenization import Tokenizer, get_tokenizer
from .base import BaseModel
from .salmonn import (
    SalmonnConfig,
    encode_speech,
    init_salmonn,
    salmonn_7b,
    salmonn_13b,
    salmonn_bench,
    salmonn_tiny,
    salmonn_train_loss,
)
from .stream_convert import flatten_tree, load_params_dir

logger = logging.getLogger(__name__)

SALMONN_PRESETS = {
    "salmonn": salmonn_13b,
    "salmonn-13b": salmonn_13b,
    "salmonn-7b": salmonn_7b,
    "salmonn-tiny": salmonn_tiny,
    "salmonn-bench": salmonn_bench,
}


def _float_dtype(tree) -> torch.dtype:
    """The dtype of a tensor tree's first floating-point leaf."""
    return next(v.dtype for v in flatten_tree(tree).values() if v.is_floating_point())


class SalmonnModel(BaseModel):
    """Config + params + tokenizer + the generation engine; ``forward`` and
    ``generate_output`` take lists of ICLSample (host structures)."""

    def __init__(self, cfg: SalmonnConfig, params: Dict[str, Any], tokenizer: Tokenizer,
                 pack_cfg: Optional[PackConfig] = None, generation=None, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.pack_cfg = pack_cfg or PackConfig(audio_tokens_per_slot=cfg.audio_tokens_per_slot)
        self.engine = SalmonnEngine(cfg, params, tokenizer, generation, device)

    def forward(self, samples: Sequence[ICLSample]) -> Dict[str, Any]:
        batch = collate_icl_batch(list(samples), self.tokenizer, self.pack_cfg)
        arrays = {"text_tokens": batch.text_tokens, "gather_idx": batch.gather_idx,
                  "seq_mask": batch.seq_mask, "shifted_labels": batch.labels_shifted,
                  "wavs": batch.audio["wavs"]}
        dev = {k: torch.as_tensor(np.asarray(v), device=self.engine.device)
               for k, v in arrays.items()}
        return {"loss": salmonn_train_loss(self.cfg, self.params, dev)}

    def generate_output(self, samples: Sequence[ICLSample]) -> List[str]:
        batch = collate_icl_batch(list(samples), self.tokenizer, self.pack_cfg)
        return self.engine.generate(batch, batch.audio)

    def get_speech_embeddings(self, wavs) -> torch.Tensor:
        """(ref: models/base_model.py:52-64): raw wavs (N, n) → (N, T_a, llm_dim)."""
        wavs = torch.as_tensor(np.asarray(wavs), device=self.engine.device)
        mels = log_mel_spectrogram(wavs)
        return encode_speech(self.cfg, self.params, mels,
                             wavs if self.cfg.beats is not None else None)

    def load_trainable(self, ckpt_dir: str) -> Dict[str, Any]:
        """Replace the trainable subtrees with a checkpoint's (``state.npy``,
        written by either package), each stored as the subtree it replaces;
        returns the checkpoint's ``train_meta.json``."""
        state = load_checkpoint(ckpt_dir)
        trainable = {k: params_from_numpy(v, self.engine.device, _float_dtype(self.params[k]))
                     if k in self.params else v for k, v in state["trainable"].items()}
        self.params = apply_trainable(self.params, trainable)
        self.engine.params = self.params
        return state.get("meta", {})


def _check_tree_shapes(name: str, expect, got) -> None:
    """Converted adapter leaves must match the preset's init shapes: a
    mismatch means the wrong --model_type was used at convert or load time."""
    flat_e = {k: tuple(v.shape) for k, v in flatten_tree(expect).items()}
    for k, v in flatten_tree(got).items():
        if k in flat_e and flat_e[k] != tuple(v.shape):
            raise ValueError(
                f"adapter '{name}/{k}' shape {tuple(v.shape)} does not match "
                f"the model preset's {flat_e[k]} — wrong --model_type?")


def create_model(model_type: str = "salmonn-tiny", tokenizer: Optional[str] = None,
                 seed: int = 0, pack_cfg: Optional[PackConfig] = None, generation=None,
                 device="cuda", trainable_dtype=None, llm_params_dir: Optional[str] = None,
                 adapter_params_dir: Optional[str] = None) -> SalmonnModel:
    """(ref: models/model_factory.py:29-97) A SALMONN preset with random
    weights from ``seed`` on ``device``; ``trainable_dtype`` (training: f32)
    stores LoRA and the Q-Former apart from the frozen weights' compute dtype.

    ``llm_params_dir``: converted decoder weights (``cli/convert.py`` output:
    float, int8 ``{q, s}`` or int4 ``{q4, s}``) replace the LLM, which is then
    never drawn. Its leaves are copied to the device one at a time from the
    memory-mapped files, floats in the compute dtype, quantized scales f32.

    ``adapter_params_dir``: converted ``salmonn_v1.pth`` adapter weights
    (``cli/convert.py --component salmonn``: Q-Former + speech projection +
    LoRA; ref layout: models/custom_salmon.py:83, PEFT nesting :190-192).
    Subtrees present in the dir (``qformer``/``lora``) replace their
    random-init counterparts; shapes are checked against the preset's."""
    key = model_type.lower()
    if key not in SALMONN_PRESETS:
        raise NotImplementedError(
            f"model type '{model_type}' is not ported; options: {sorted(SALMONN_PRESETS)}")
    cfg = SALMONN_PRESETS[key]()
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_salmonn(cfg, gen, dev, dtype=cfg.compute_dtype,
                          trainable_dtype=trainable_dtype, skip_llm=bool(llm_params_dir))
    if llm_params_dir:
        params["llm"] = params_from_numpy(load_params_dir(llm_params_dir), dev,
                                          cfg.compute_dtype)
        logger.info(f"Loaded converted LLM weights from {llm_params_dir}")
    if adapter_params_dir:
        adapter = load_params_dir(adapter_params_dir)
        for sub in ("qformer", "lora"):
            if sub not in adapter:
                continue
            if sub in params:
                _check_tree_shapes(sub, params[sub], adapter[sub])
            params[sub] = params_from_numpy(adapter[sub], dev,
                                            trainable_dtype or cfg.compute_dtype)
        logger.info(f"Loaded converted adapter weights from {adapter_params_dir}"
                    f" ({sorted(adapter)})")
    logger.info(f"Created {key} on {dev} (seed {seed})")
    return SalmonnModel(cfg, params, get_tokenizer(tokenizer), pack_cfg, generation, dev)


def from_config(config: Dict[str, Any]) -> SalmonnModel:
    """(ref: models/model_factory.py:100-150)"""
    return create_model(**config)


def get_model_from_checkpoint(checkpoint_path: str, model_type: str = "salmonn-tiny",
                              **kw) -> SalmonnModel:
    """(ref: models/model_factory.py:328-386) ``create_model(model_type,
    **kw)``, then the checkpoint's trainable subtrees in place of the
    preset's."""
    model = create_model(model_type, **kw)
    meta = model.load_trainable(checkpoint_path)
    logger.info(f"Restored trainable params from {checkpoint_path}: {meta}")
    return model
