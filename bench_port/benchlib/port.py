"""What every family hands the port alike: the packing budget of a traffic
mix, the engine's greedy generation settings, the decoder's quantization
as the configuration states it, and memory given back before the
reference runs."""

from __future__ import annotations

import gc
from typing import Callable, Dict, Optional

import torch


def pack_config(spec: Dict, audio_tokens_per_slot: int,
                audio_len_fn: Optional[Callable] = None):
    from icl_speech_text_llm_tpu_torch.data.packing import PackConfig

    task = spec["task"]
    slots = task["k"] + 1 if task["fewshot_mode"] == "speech" else 1
    return PackConfig(seq_len=spec["seq_len"], text_len=spec["text_len"], max_slots=slots,
                      audio_tokens_per_slot=audio_tokens_per_slot, audio_len_fn=audio_len_fn)


def quantize(cfg: Dict, decoder: Dict) -> None:
    """The decoder's weights (and lm_head) quantized in place, where the
    configuration's ``quant`` says so."""
    from icl_speech_text_llm_tpu_torch.ops.quant import quantize_decoder

    q = cfg.get("quant")
    if not q:
        return
    if q["lm_head_bits"] not in (None, 8):
        raise ValueError("the port's quantize_decoder makes the lm_head int8 or leaves it")
    quantize_decoder(decoder, include_lm_head=q["lm_head_bits"] == 8, bits=q["weight_bits"],
                     group=q["group"])


def generation(cfg: Dict, spec: Dict, tokenizer):
    """Greedy decoding of the traffic's ``max_new_tokens``, from an int8 KV
    cache and by flash decode where the configuration's ``quant`` says so."""
    from icl_speech_text_llm_tpu_torch.inference.engine import GenerationConfig

    q = cfg.get("quant")
    return GenerationConfig(max_new_tokens=spec["max_new_tokens"],
                            eos_token_id=tokenizer.eos_token_id,
                            pad_token_id=tokenizer.pad_token_id,
                            kv_int8=bool(q and q["kv_int8"]),
                            use_flash_decode=True if q and q.get("flash_decode") else "xla")


def free(device) -> None:
    """Give the freed program's memory back before the reference runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
