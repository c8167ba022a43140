"""A configuration file → the port's Qwen2-Audio configuration, built from
the file's own sizes, so the file is the configuration as it is run."""

from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_config(cfg: Dict):
    from icl_speech_text_llm_tpu_torch.models.llama import DecoderConfig, LoraConfig
    from icl_speech_text_llm_tpu_torch.models.qwen_audio import QwenAudioConfig
    from icl_speech_text_llm_tpu_torch.models.whisper import WhisperEncoderConfig

    a, t, lora = cfg["audio_config"], cfg["text_config"], cfg.get("lora")
    if a["encoder_ffn_dim"] != 4 * a["d_model"]:
        raise ValueError("the port's audio tower has an FFN of 4 × d_model")
    encoder = WhisperEncoderConfig(n_mels=a["num_mel_bins"], n_ctx=a["max_source_positions"],
                                   dim=a["d_model"], n_heads=a["encoder_attention_heads"],
                                   n_layers=a["encoder_layers"])
    llm = DecoderConfig(vocab_size=t["vocab_size"], dim=t["hidden_size"],
                        n_layers=t["num_hidden_layers"], n_heads=t["num_attention_heads"],
                        n_kv_heads=t["num_key_value_heads"], hidden_dim=t["intermediate_size"],
                        rope_theta=t["rope_theta"], rms_eps=t["rms_norm_eps"],
                        qkv_bias=t["qkv_bias"], tie_embeddings=t["tie_word_embeddings"],
                        max_seq_len=t["max_position_embeddings"])
    return QwenAudioConfig(
        encoder=encoder, llm=llm, pool_stride=cfg["audio_pool_stride"],
        lora=LoraConfig(rank=lora["rank"], alpha=lora["alpha"], targets=tuple(lora["targets"]))
        if lora else None,
        compute_dtype=DTYPES[cfg["torch_dtype"]])
