"""Qwen2-Audio's side of the harness: the configuration file's
``audio_config``, ``text_config`` and ``audio_pool_stride`` as the port's
``QwenAudioConfig``, the tree the port's Qwen2-Audio takes, its chat
prompt, its model for evaluation and its train loss, and the work of its
tower.

The tree has the shapes and key names that the port's Qwen2-Audio takes
(stacked ``(L, ...)`` layer leaves, matmul weights stored ``(in, out)``),
and the reference reads the same tree. Matmul weights are N(0, 1/in);
embeddings N(0, 0.02²); biases N(0, 0.02²); norms 1; LoRA A N(0, 1/in) and
B N(0, 0.01²), so the adapter is not the identity.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

from benchlib import port
from benchlib import roofline as R
from benchlib import weights as W
from benchlib import work
from reference.model import audio_frames

#: the operations of ``opmap.json`` cover every kernel this family runs
OPS: Dict[str, List[str]] = {}

#: the tower's frames a clip: the model pads each clip to 30 s
TOWER_FRAMES = 1500


def port_config(cfg: Dict):
    """The port's Qwen2-Audio configuration, built from the file's own sizes,
    so the file is the configuration as it is run."""
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
        compute_dtype=W.DTYPES[cfg["torch_dtype"]])


def mismatches(cfg: Dict, pc) -> List[str]:
    """The file's sizes that the port's configuration does not hold."""
    a, t = cfg["audio_config"], cfg["text_config"]
    pairs = {
        "audio_config.encoder_layers": (pc.encoder.n_layers, a["encoder_layers"]),
        "audio_config.d_model": (pc.encoder.dim, a["d_model"]),
        "audio_config.encoder_attention_heads": (pc.encoder.n_heads,
                                                 a["encoder_attention_heads"]),
        "audio_config.num_mel_bins": (pc.encoder.n_mels, a["num_mel_bins"]),
        "text_config.num_hidden_layers": (pc.llm.n_layers, t["num_hidden_layers"]),
        "text_config.hidden_size": (pc.llm.dim, t["hidden_size"]),
        "text_config.num_attention_heads": (pc.llm.n_heads, t["num_attention_heads"]),
        "text_config.num_key_value_heads": (pc.llm.n_kv_heads, t["num_key_value_heads"]),
        "text_config.intermediate_size": (pc.llm.hidden_dim, t["intermediate_size"]),
        "text_config.vocab_size": (pc.llm.vocab_size, t["vocab_size"]),
        "text_config.rope_theta": (pc.llm.rope_theta, t["rope_theta"]),
        "text_config.rms_norm_eps": (pc.llm.rms_eps, t["rms_norm_eps"]),
        "text_config.qkv_bias": (pc.llm.qkv_bias, t["qkv_bias"]),
        "audio_pool_stride": (pc.pool_stride, cfg["audio_pool_stride"]),
        "torch_dtype": (pc.compute_dtype, W.DTYPES[cfg["torch_dtype"]]),
    }
    return [k for k, (port_value, file_value) in pairs.items() if port_value != file_value]


def dims(cfg: Dict) -> Dict[str, int]:
    a, t = cfg["audio_config"], cfg["text_config"]
    hd = t["hidden_size"] // t["num_attention_heads"]
    return {
        "mels": a["num_mel_bins"], "d": a["d_model"], "enc_layers": a["encoder_layers"],
        "enc_heads": a["encoder_attention_heads"], "enc_ffn": a["encoder_ffn_dim"],
        "frames": a["max_source_positions"],
        "D": t["hidden_size"], "L": t["num_hidden_layers"], "H": t["num_attention_heads"],
        "Hkv": t["num_key_value_heads"], "hd": hd, "F": t["intermediate_size"],
        "V": t["vocab_size"], "pool": cfg["audio_pool_stride"],
    }


def leaf_plan(cfg: Dict):
    """[(path, shape, init)] in drawing order; init is ("normal", std),
    ("ones",) or ("sinusoids",)."""
    n = dims(cfg)
    d, L, Le, D = n["d"], n["L"], n["enc_layers"], n["D"]
    q_out, kv_out = n["H"] * n["hd"], n["Hkv"] * n["hd"]

    def w(i, o, lead=()):
        return (lead + (i, o), ("normal", i ** -0.5))

    def bias(*shape):
        return (shape, ("normal", 0.02))

    def ones(*shape):
        return (shape, ("ones",))

    plan = [
        (("encoder", "conv1", "w"), (3, n["mels"], d), ("normal", (3 * n["mels"]) ** -0.5)),
        (("encoder", "conv1", "b"),) + bias(d),
        (("encoder", "conv2", "w"), (3, d, d), ("normal", (3 * d) ** -0.5)),
        (("encoder", "conv2", "b"),) + bias(d),
        (("encoder", "positions"), (n["frames"], d), ("sinusoids",)),
    ]
    blk = ("encoder", "blocks")
    for name, spec in (
        (("ln1", "w"), ones(Le, d)), (("ln1", "b"), bias(Le, d)),
        (("attn", "wq"), w(d, d, (Le,))), (("attn", "bq"), bias(Le, d)),
        (("attn", "wk"), w(d, d, (Le,))),
        (("attn", "wv"), w(d, d, (Le,))), (("attn", "bv"), bias(Le, d)),
        (("attn", "wo"), w(d, d, (Le,))), (("attn", "bo"), bias(Le, d)),
        (("ln2", "w"), ones(Le, d)), (("ln2", "b"), bias(Le, d)),
        (("mlp", "w1"), w(d, n["enc_ffn"], (Le,))), (("mlp", "b1"), bias(Le, n["enc_ffn"])),
        (("mlp", "w2"), w(n["enc_ffn"], d, (Le,))), (("mlp", "b2"), bias(Le, d)),
    ):
        plan.append((blk + name,) + spec)
    plan += [
        (("encoder", "ln_post", "w"),) + ones(d),
        (("encoder", "ln_post", "b"),) + bias(d),
        (("projector", "w"),) + w(d, D),
        (("projector", "b"),) + bias(D),
    ]
    lora = cfg.get("lora")
    if lora:
        r = lora["rank"]
        outs = {"wq": q_out, "wk": kv_out, "wv": kv_out}
        for tgt in lora["targets"]:
            plan.append((("lora", tgt, "a"), (L, D, r), ("normal", D ** -0.5)))
            plan.append((("lora", tgt, "b"), (L, r, outs[tgt]), ("normal", 0.01)))
    lay = ("llm", "layers")
    plan.append((("llm", "tok_embed"), (n["V"], D), ("normal", 0.02)))
    for name, spec in (
        (("attn", "wq"), w(D, q_out, (L,))), (("attn", "wk"), w(D, kv_out, (L,))),
        (("attn", "wv"), w(D, kv_out, (L,))), (("attn", "wo"), w(q_out, D, (L,))),
        (("attn", "bq"), bias(L, q_out)), (("attn", "bk"), bias(L, kv_out)),
        (("attn", "bv"), bias(L, kv_out)),
        (("mlp", "w_gate"), w(D, n["F"], (L,))), (("mlp", "w_up"), w(D, n["F"], (L,))),
        (("mlp", "w_down"), w(n["F"], D, (L,))),
        (("ln_attn",), ones(L, D)), (("ln_mlp",), ones(L, D)),
    ):
        if name[0] == "attn" and name[1].startswith("b") and not cfg["text_config"]["qkv_bias"]:
            continue
        plan.append((lay + name,) + spec)
    plan.append((("llm", "final_norm"),) + ones(D))
    plan.append((("llm", "lm_head"),) + w(D, n["V"]))
    return plan


def pack_config(spec: Dict, pc):
    return port.pack_config(spec, pc.audio_tokens_per_slot, pc.audio_len_fn)


def eval_model(cfg: Dict, spec: Dict, params: Dict[str, Any], device):
    """The port's Qwen2-Audio over ``params`` (quantized in place where the
    file says so), with its static engine and packing."""
    from icl_speech_text_llm_tpu_torch.models.factory import QwenAudioModel
    from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

    pc = port_config(cfg)
    port.quantize(cfg, params["llm"])
    tok = get_tokenizer()
    return QwenAudioModel(pc, params, tok, pack_config(spec, pc), port.generation(cfg, spec, tok),
                          device)


def train_loss():
    from icl_speech_text_llm_tpu_torch.models.qwen_audio import qwen_audio_train_loss

    return qwen_audio_train_loss


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


def tower(cfg: Dict, w: R.Work, clip_frames: Sequence[int]) -> None:
    """The tower over clips with these valid frame counts (forward): the
    ``TOWER_FRAMES`` a clip with attention over each clip's valid keys."""
    n = dims(cfg)
    d, ffn, H, Le = n["d"], n["enc_ffn"], n["enc_heads"], n["enc_layers"]
    T = TOWER_FRAMES
    per_clip = (2.0 * 2 * T * 3 * n["mels"] * d + 2.0 * T * 3 * d * d
                + Le * 2.0 * T * (4 * d * d + 2 * d * ffn)
                + 2.0 * (T // n["pool"]) * d * n["D"])
    for f in clip_frames:
        w.model_flops += per_clip + Le * 4.0 * d * T * f
        fl, by = R.attention_fwd(H, H, d // H, f, f * f, f)
        w.add("tower_attention", Le * fl, Le * by)


def eval_work(cfg: Dict, w: R.Work, clip_samples: Sequence[int],
              prompts: Sequence[int], new_tokens: int) -> None:
    n = dims(cfg)
    tower(cfg, w, [audio_frames(s) for s in clip_samples])
    work.decoder_prefill(cfg, n, w, prompts)
    work.decode(cfg, n, w, prompts, new_tokens)


def train_work(cfg: Dict, w: R.Work, clip_samples: Sequence[int],
               positions: Sequence[int]) -> None:
    tower(cfg, w, [audio_frames(s) for s in clip_samples])
    work.train_step(cfg, dims(cfg), w, positions)
