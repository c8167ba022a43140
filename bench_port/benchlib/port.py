"""What the benchmark hands the port: raw request fields as the port's
``ICLSample``s, the prompt built by the port's own Qwen chat-format
builder, and the port's packing budget for a traffic mix."""

from __future__ import annotations

import gc
from typing import Dict, List

import torch


def samples(traffic, batch) -> List:
    from icl_speech_text_llm_tpu_torch.data.collate import ICLSample
    from icl_speech_text_llm_tpu_torch.data.prompts import build_qwen_prompt

    task = traffic.task
    out = []
    for req in batch:
        examples = [{"label": e.label, "text": e.text} for e in req.examples]
        plan = build_qwen_prompt(task["template"], req.text, examples,
                                 input_mode=task["input_mode"],
                                 fewshot_mode=task["fewshot_mode"])
        audio = {}
        for kind, i in plan.slots:
            clip = req.main_clip if kind == "main" else req.examples[i].clip
            audio[(kind, i)] = traffic.wav(clip)
        out.append(ICLSample(plan=plan, completion=req.label, slot_audio=audio, extras={}))
    return out


def pack_config(spec: Dict, port_cfg):
    from icl_speech_text_llm_tpu_torch.data.packing import PackConfig

    task = spec["task"]
    slots = task["k"] + 1 if task["fewshot_mode"] == "speech" else 1
    return PackConfig(seq_len=spec["seq_len"], text_len=spec["text_len"], max_slots=slots,
                      audio_tokens_per_slot=port_cfg.audio_tokens_per_slot,
                      audio_len_fn=port_cfg.audio_len_fn)


def free(device) -> None:
    """Give the freed program's memory back before the reference runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
