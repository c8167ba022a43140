"""Checkpoint conversion: torch/HF state dicts → the port's parameter trees.

Counterpart of ``icl_speech_text_llm_tpu/models/convert.py`` in numpy alone
(layers are stacked by ``_stack``, a nested-dict ``np.stack``), so the
machine with the card converts without jax or safetensors. Covers the
reference's weight sources (SURVEY.md §7.3 hard part #2):
- HF LLaMA/Vicuna and Qwen2 decoders (``model.layers.N.*``);
- HF Whisper encoder (``encoder.layers.N.*``);
- SALMONN v1 checkpoints (``salmonn_v1.pth``: Q-Former, projection, LoRA over
  Vicuna with PEFT-nested keys; ref: models/custom_salmon.py:83,190-192);
- BEATs (microsoft/unilm layout).

All converters consume a flat ``{name: numpy array}`` dict; load torch and
safetensors files with ``load_torch_state_dict`` (CPU, no grad). Linear
weights transpose from torch's (out, in) to the tree's (in, out).
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, Mapping

import numpy as np

from .llama import DecoderConfig
from .qformer import QFormerConfig
from .stream_convert import unwrap_state_dict
from .whisper import WhisperEncoderConfig

logger = logging.getLogger(__name__)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a .pt/.pth/.bin/.safetensors file into numpy (no CUDA required)."""
    if path.endswith(".safetensors"):
        from ..utils.safetensors_np import load_file

        return load_file(path)
    import torch

    obj = unwrap_state_dict(torch.load(path, map_location="cpu", weights_only=False))
    return {k: v.float().numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in obj.items()}


def _stack(layers):
    """A list of same-structure nested dicts → one dict, leaves stacked on a
    new leading axis."""
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return np.stack(layers)


def _t(w: np.ndarray) -> np.ndarray:
    """torch Linear (out, in) → ours (in, out)."""
    return np.ascontiguousarray(w.T)


def convert_hf_decoder(
    sd: Mapping[str, np.ndarray], cfg: DecoderConfig, prefix: str = "model."
) -> Dict[str, Any]:
    """HF LLaMA/Qwen2 state dict → our decoder tree.

    Handles both plain HF names and PEFT-nested ones (base_model.model. ...,
    the trap at ref: models/custom_salmon.py:190-192) via prefix stripping.
    """
    sd = {re.sub(r"^(base_model\.model\.)+", "", k): v for k, v in sd.items()}

    def g(name):
        for cand in (prefix + name, name):
            if cand in sd:
                return sd[cand]
        raise KeyError(f"missing weight: {prefix + name}")

    layers = []
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        layer = {
            "attn": {
                "wq": _t(g(p + "self_attn.q_proj.weight")),
                "wk": _t(g(p + "self_attn.k_proj.weight")),
                "wv": _t(g(p + "self_attn.v_proj.weight")),
                "wo": _t(g(p + "self_attn.o_proj.weight")),
            },
            "mlp": {
                "w_gate": _t(g(p + "mlp.gate_proj.weight")),
                "w_up": _t(g(p + "mlp.up_proj.weight")),
                "w_down": _t(g(p + "mlp.down_proj.weight")),
            },
            "ln_attn": g(p + "input_layernorm.weight"),
            "ln_mlp": g(p + "post_attention_layernorm.weight"),
        }
        if cfg.qkv_bias:
            layer["attn"]["bq"] = g(p + "self_attn.q_proj.bias")
            layer["attn"]["bk"] = g(p + "self_attn.k_proj.bias")
            layer["attn"]["bv"] = g(p + "self_attn.v_proj.bias")
        layers.append(layer)

    params = {
        "tok_embed": g("embed_tokens.weight"),
        "layers": _stack(layers),
        "final_norm": g("norm.weight"),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _t(sd["lm_head.weight"])
    return params


def convert_hf_whisper_encoder(
    sd: Mapping[str, np.ndarray], cfg: WhisperEncoderConfig, prefix: str = "model.encoder."
) -> Dict[str, Any]:
    """HF WhisperEncoder state dict → our encoder tree."""

    def g(name):
        for cand in (prefix + name, "encoder." + name, name):
            if cand in sd:
                return sd[cand]
        raise KeyError(f"missing weight: {prefix + name}")

    blocks = []
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        blocks.append(
            {
                "ln1": {"w": g(p + "self_attn_layer_norm.weight"),
                        "b": g(p + "self_attn_layer_norm.bias")},
                "attn": {
                    "wq": _t(g(p + "self_attn.q_proj.weight")),
                    "bq": g(p + "self_attn.q_proj.bias"),
                    "wk": _t(g(p + "self_attn.k_proj.weight")),
                    "wv": _t(g(p + "self_attn.v_proj.weight")),
                    "bv": g(p + "self_attn.v_proj.bias"),
                    "wo": _t(g(p + "self_attn.out_proj.weight")),
                    "bo": g(p + "self_attn.out_proj.bias"),
                },
                "ln2": {"w": g(p + "final_layer_norm.weight"),
                        "b": g(p + "final_layer_norm.bias")},
                "mlp": {
                    "w1": _t(g(p + "fc1.weight")), "b1": g(p + "fc1.bias"),
                    "w2": _t(g(p + "fc2.weight")), "b2": g(p + "fc2.bias"),
                },
            }
        )

    def conv(w):  # torch conv1d weight (out, in, k) → ours (k, in, out)
        return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))

    return {
        "conv1": {"w": conv(g("conv1.weight")), "b": g("conv1.bias")},
        "conv2": {"w": conv(g("conv2.weight")), "b": g("conv2.bias")},
        "positions": g("embed_positions.weight"),
        "blocks": _stack(blocks),
        "ln_post": {"w": g("layer_norm.weight"), "b": g("layer_norm.bias")},
    }


def convert_salmonn_checkpoint(
    sd: Mapping[str, np.ndarray],
    qformer_cfg: QFormerConfig,
    llm_cfg: DecoderConfig,
    lora_targets=("wq", "wv"),
) -> Dict[str, Any]:
    """salmonn_v1.pth trainable parts → {qformer, lora} trees.

    The SALMONN checkpoint stores: speech_query_tokens, speech_Qformer.bert.*,
    speech_llama_proj.*, and PEFT LoRA tensors
    ``llama_model...layers.N.self_attn.{q,v}_proj.lora_{A,B}[.default].weight``.
    """
    out: Dict[str, Any] = {}

    lora: Dict[str, Any] = {}
    proj_names = {"wq": "q_proj", "wk": "k_proj", "wv": "v_proj", "wo": "o_proj"}
    for tgt in lora_targets:
        proj = proj_names[tgt]
        a_list, b_list = [], []
        for i in range(llm_cfg.n_layers):
            a_key = _find(sd, rf"layers\.{i}\.self_attn\.{proj}\.lora_A\.(default\.)?weight$")
            b_key = _find(sd, rf"layers\.{i}\.self_attn\.{proj}\.lora_B\.(default\.)?weight$")
            if a_key is None or b_key is None:
                break
            a_list.append(_t(sd[a_key]))  # (in, r)
            b_list.append(_t(sd[b_key]))  # (r, out)
        if a_list:
            lora[tgt] = {"a": np.stack(a_list), "b": np.stack(b_list)}
    if lora:
        out["lora"] = lora

    q_key = _find(sd, r"speech_query_tokens$")
    if q_key is not None:
        qf: Dict[str, Any] = {"query_tokens": sd[q_key].reshape(-1, qformer_cfg.dim)}
        ln_w = _find(sd, r"ln_speech\.weight$")
        if ln_w is not None:
            # the reference concatenates ln_speech/ln_audio over the feature dim
            ln_b = _find(sd, r"ln_speech\.bias$")
            la_w = _find(sd, r"ln_audio\.weight$")
            la_b = _find(sd, r"ln_audio\.bias$")
            w = sd[ln_w]
            b = sd[ln_b]
            if la_w is not None:
                w = np.concatenate([w, sd[la_w]])
                b = np.concatenate([b, sd[la_b]])
            qf["ln_input"] = {"w": w, "b": b}
        layers = []
        for i in range(qformer_cfg.n_layers):
            bert = f"speech_Qformer.bert.encoder.layer.{i}."
            try:
                layers.append(_convert_bert_layer(sd, bert))
            except KeyError:
                break
        if layers:
            qf["layers"] = _stack(layers)
        pw = _find(sd, r"speech_llama_proj\.weight$")
        if pw is not None:
            qf["proj"] = {"w": _t(sd[pw]), "b": sd[_find(sd, r"speech_llama_proj\.bias$")]}
        out["qformer"] = qf
    return out


def _convert_bert_layer(sd, p):
    def g(name):
        key = _find(sd, re.escape(p + name) + "$")
        if key is None:
            raise KeyError(p + name)
        return sd[key]

    return {
        "self_attn": {
            "wq": _t(g("attention.self.query.weight")), "bq": g("attention.self.query.bias"),
            "wk": _t(g("attention.self.key.weight")), "bk": g("attention.self.key.bias"),
            "wv": _t(g("attention.self.value.weight")), "bv": g("attention.self.value.bias"),
            "wo": _t(g("attention.output.dense.weight")), "bo": g("attention.output.dense.bias"),
        },
        "ln_self": {"w": g("attention.output.LayerNorm.weight"),
                    "b": g("attention.output.LayerNorm.bias")},
        "cross_attn": {
            "wq": _t(g("crossattention.self.query.weight")),
            "bq": g("crossattention.self.query.bias"),
            "wk": _t(g("crossattention.self.key.weight")),
            "bk": g("crossattention.self.key.bias"),
            "wv": _t(g("crossattention.self.value.weight")),
            "bv": g("crossattention.self.value.bias"),
            "wo": _t(g("crossattention.output.dense.weight")),
            "bo": g("crossattention.output.dense.bias"),
        },
        "ln_cross": {"w": g("crossattention.output.LayerNorm.weight"),
                     "b": g("crossattention.output.LayerNorm.bias")},
        "mlp": {
            "w1": _t(g("intermediate_query.dense.weight")),
            "b1": g("intermediate_query.dense.bias"),
            "w2": _t(g("output_query.dense.weight")), "b2": g("output_query.dense.bias"),
        },
        "ln_mlp": {"w": g("output_query.LayerNorm.weight"),
                   "b": g("output_query.LayerNorm.bias")},
    }


def _find(sd: Mapping[str, np.ndarray], pattern: str):
    for k in sd:
        if re.search(pattern, k):
            return k
    return None


def convert_beats(sd: Mapping[str, np.ndarray], cfg) -> Dict[str, Any]:
    """BEATs checkpoint (microsoft/unilm layout) → our encoder tree.

    Accepts the raw `BEATs_iter3_plus_AS2M*.pt` state dict (keys like
    `patch_embedding.weight`, `encoder.layers.N.self_attn.*`) or the same
    nested under a `beats.` prefix (as SALMONN stores its audio tower;
    ref: models/custom_salmon.py:32,67). Predictor/pretraining heads are
    ignored. The relative-attention-bias table is shared across layers in
    BEATs (layer 0 owns it); it is stored once at the top level.
    """
    sd = {re.sub(r"^(beats\.)", "", k): np.asarray(v) for k, v in sd.items()}

    def g(name):
        if name in sd:
            return sd[name]
        raise KeyError(f"missing BEATs weight: {name}")

    # pos_conv is weight-normalized with dim=2 (fairseq): weight_g (1,1,K),
    # weight_v (O, I, K); weight = g * v / ||v||_{dims 0,1}
    wv = g("encoder.pos_conv.0.weight_v")
    wg = g("encoder.pos_conv.0.weight_g")
    norm = np.sqrt((wv**2).sum(axis=(0, 1), keepdims=True))
    w_pos = wg * wv / np.maximum(norm, 1e-12)  # (O, I, K)
    w_pos = np.ascontiguousarray(np.transpose(w_pos, (2, 1, 0)))  # (K, I, O)

    layers = []
    for i in range(cfg.n_layers):
        p = f"encoder.layers.{i}."
        attn = {
            "wq": _t(g(p + "self_attn.q_proj.weight")), "bq": g(p + "self_attn.q_proj.bias"),
            "wk": _t(g(p + "self_attn.k_proj.weight")), "bk": g(p + "self_attn.k_proj.bias"),
            "wv": _t(g(p + "self_attn.v_proj.weight")), "bv": g(p + "self_attn.v_proj.bias"),
            "wo": _t(g(p + "self_attn.out_proj.weight")), "bo": g(p + "self_attn.out_proj.bias"),
        }
        if cfg.gated_rel_pos:
            attn["grep_w"] = _t(g(p + "self_attn.grep_linear.weight"))
            attn["grep_b"] = g(p + "self_attn.grep_linear.bias")
            attn["grep_a"] = g(p + "self_attn.grep_a").reshape(-1)
        layers.append({
            "attn": attn,
            "ln_attn": {"w": g(p + "self_attn_layer_norm.weight"),
                        "b": g(p + "self_attn_layer_norm.bias")},
            "mlp": {
                "w1": _t(g(p + "fc1.weight")), "b1": g(p + "fc1.bias"),
                "w2": _t(g(p + "fc2.weight")), "b2": g(p + "fc2.bias"),
            },
            "ln_mlp": {"w": g(p + "final_layer_norm.weight"),
                       "b": g(p + "final_layer_norm.bias")},
        })

    params = {
        # torch conv2d (O, 1, kH, kW) → HWIO (kH, kW, 1, O)
        "patch_embed": {
            "w": np.ascontiguousarray(np.transpose(g("patch_embedding.weight"), (2, 3, 1, 0))),
            "b": g("patch_embedding.bias"),
        },
        "ln_patch": {"w": g("layer_norm.weight"), "b": g("layer_norm.bias")},
        "post_proj": {"w": _t(g("post_extract_proj.weight")),
                      "b": g("post_extract_proj.bias")},
        "conv_pos": {"w": w_pos, "b": g("encoder.pos_conv.0.bias")},
        "ln_pre": {"w": g("encoder.layer_norm.weight"), "b": g("encoder.layer_norm.bias")},
        "layers": _stack(layers),
    }
    if cfg.gated_rel_pos:
        params["rel_bias"] = g("encoder.layers.0.self_attn.relative_attention_bias.weight")
    return params
