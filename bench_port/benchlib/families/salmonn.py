"""SALMONN's side of the harness: the configuration file's
``whisper_config``, ``beats_config``, ``qformer_config`` and ``text_config``
as the port's ``SalmonnConfig``, the tree the port's SALMONN takes, its ICL
prompt, its model for evaluation, and the work of its two encoders and
its window Q-Former.

The tree has the shapes and key names of the port's ``init_salmonn``
(stacked ``(L, ...)`` layer leaves, matmul weights stored ``(in, out)``),
and the reference reads the same tree. Matmul weights are N(0, 1/in);
embeddings N(0, 0.02²); biases N(0, 0.02²); norms 1; LoRA A N(0, 1/in) and
B N(0, 0.01²), so the adapter is not the identity. Four draws differ, so
that what SALMONN adds moves the result as a trained model's does:
Whisper's final norm is N(0, 0.5²), so its columns reach the Q-Former at
another scale than BEATs' (a joint norm over both then differs from
SALMONN's two); BEATs' relative-position table is N(0, 1), so the gated
bias moves its attention; the query token is N(0, 1), a row as the BERT
embeddings' norm, folded into it at conversion, leaves it; the token
embeddings are N(0, 1), the scale at which the projection puts the speech
positions, as a trained SALMONN's projection puts speech at its token
embeddings' scale. At N(0, 0.02²) the text weighs a fiftieth of the
speech, every prompt of the traffic's noise clips looks alike to the
decoder, and at some seeds every request is served one token throughout,
so that even an fp8 copy of the model serves the same.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

from benchlib import port
from benchlib import roofline as R
from benchlib import weights as W
from benchlib import work

#: K3 (and K8/K9, its schedules) computes BEATs' gated-bias attention
OPS: Dict[str, List[str]] = {"beats_attention": ["gated_bias_wgmma_kernel"]}

#: Whisper's frames a clip: every clip is padded to 30 s and no key is masked
WHISPER_FRAMES = 1500
#: samples of the 30 s every clip is padded to
CLIP_SAMPLES = 30 * 16_000


def window(cfg: Dict) -> int:
    """Encoder frames a Q-Former window takes (and strides by):
    ``round(1500 · second_per_window / 30)``, as SALMONN computes it."""
    q = cfg["qformer_config"]
    frames = round(WHISPER_FRAMES * q["second_per_window"] / 30.0)
    if round(WHISPER_FRAMES * q["second_stride"] / 30.0) != frames:
        raise ValueError("the port's Q-Former takes windows that do not overlap")
    return frames


def beats_tokens(cfg: Dict) -> int:
    """BEATs' tokens of a 30-s clip: Kaldi frames (25 ms, 10 ms hop) cut
    into patches; 1496."""
    b = cfg["beats_config"]
    frames = (CLIP_SAMPLES - 400) // 160 + 1
    p = b["input_patch_size"]
    return (frames // p) * (b["n_fbank"] // p)


def port_config(cfg: Dict):
    """The port's SALMONN configuration, built from the file's own sizes,
    so the file is the configuration as it is run."""
    from icl_speech_text_llm_tpu_torch.models.beats import BeatsConfig
    from icl_speech_text_llm_tpu_torch.models.llama import DecoderConfig, LoraConfig
    from icl_speech_text_llm_tpu_torch.models.qformer import QFormerConfig
    from icl_speech_text_llm_tpu_torch.models.salmonn import SalmonnConfig
    from icl_speech_text_llm_tpu_torch.models.whisper import WhisperEncoderConfig

    w, b, q, t = (cfg[k] for k in ("whisper_config", "beats_config", "qformer_config",
                                  "text_config"))
    lora = cfg.get("lora")
    if w["encoder_ffn_dim"] != 4 * w["d_model"]:
        raise ValueError("the port's Whisper has an FFN of 4 × d_model")
    if b["encoder_ffn_embed_dim"] % b["encoder_embed_dim"]:
        raise ValueError("the port's BEATs has an FFN of a whole multiple of its width")
    if q["intermediate_size"] % q["hidden_size"]:
        raise ValueError("the port's Q-Former has an FFN of a whole multiple of its width")
    if not (b["gru_rel_pos"] and b["deep_norm"] and not b["layer_norm_first"]):
        raise ValueError("the port's BEATs is post-LN with deep norm and the gated bias")
    whisper = WhisperEncoderConfig(n_mels=w["num_mel_bins"], n_ctx=w["max_source_positions"],
                                   dim=w["d_model"], n_heads=w["encoder_attention_heads"],
                                   n_layers=w["encoder_layers"])
    beats = BeatsConfig(n_fbank=b["n_fbank"], patch=b["input_patch_size"],
                        embed_dim=b["embed_dim"], dim=b["encoder_embed_dim"],
                        n_heads=b["encoder_attention_heads"], n_layers=b["encoder_layers"],
                        conv_pos=b["conv_pos"], conv_pos_groups=b["conv_pos_groups"],
                        mlp_ratio=b["encoder_ffn_embed_dim"] // b["encoder_embed_dim"],
                        gated_rel_pos=b["gru_rel_pos"], rel_pos_buckets=b["num_buckets"],
                        rel_pos_max_distance=b["max_distance"])
    frames = window(cfg)
    qformer = QFormerConfig(encoder_width=w["d_model"] + b["encoder_embed_dim"],
                            dim=q["hidden_size"], n_heads=q["num_attention_heads"],
                            n_layers=q["num_hidden_layers"], n_query=q["num_speech_query_token"],
                            window=frames, n_windows=(WHISPER_FRAMES - frames) // frames + 1,
                            llm_dim=t["hidden_size"],
                            mlp_ratio=q["intermediate_size"] // q["hidden_size"],
                            norm_widths=(w["d_model"], b["encoder_embed_dim"]),
                            ln_eps=q["layer_norm_eps"])
    llm = DecoderConfig(vocab_size=t["vocab_size"], dim=t["hidden_size"],
                        n_layers=t["num_hidden_layers"], n_heads=t["num_attention_heads"],
                        n_kv_heads=t["num_key_value_heads"], hidden_dim=t["intermediate_size"],
                        rope_theta=t["rope_theta"], rms_eps=t["rms_norm_eps"],
                        qkv_bias=t["qkv_bias"], tie_embeddings=t["tie_word_embeddings"],
                        max_seq_len=t["max_position_embeddings"])
    return SalmonnConfig(
        whisper=whisper, beats=beats, qformer=qformer, llm=llm,
        lora=LoraConfig(rank=lora["rank"], alpha=lora["alpha"], targets=tuple(lora["targets"]))
        if lora else None,
        compute_dtype=W.DTYPES[cfg["torch_dtype"]])


def mismatches(cfg: Dict, pc) -> List[str]:
    """The file's sizes that the port's configuration does not hold."""
    w, b, q, t = (cfg[k] for k in ("whisper_config", "beats_config", "qformer_config",
                                  "text_config"))
    pairs = {
        "whisper_config.encoder_layers": (pc.whisper.n_layers, w["encoder_layers"]),
        "whisper_config.d_model": (pc.whisper.dim, w["d_model"]),
        "whisper_config.encoder_attention_heads": (pc.whisper.n_heads,
                                                   w["encoder_attention_heads"]),
        "whisper_config.num_mel_bins": (pc.whisper.n_mels, w["num_mel_bins"]),
        "beats_config.encoder_layers": (pc.beats.n_layers, b["encoder_layers"]),
        "beats_config.encoder_embed_dim": (pc.beats.dim, b["encoder_embed_dim"]),
        "beats_config.encoder_attention_heads": (pc.beats.n_heads,
                                                 b["encoder_attention_heads"]),
        "beats_config.encoder_ffn_embed_dim": (pc.beats.mlp_ratio * pc.beats.dim,
                                               b["encoder_ffn_embed_dim"]),
        "beats_config.embed_dim": (pc.beats.embed_dim, b["embed_dim"]),
        "beats_config.input_patch_size": (pc.beats.patch, b["input_patch_size"]),
        "beats_config.n_fbank": (pc.beats.n_fbank, b["n_fbank"]),
        "beats_config.conv_pos": (pc.beats.conv_pos, b["conv_pos"]),
        "beats_config.conv_pos_groups": (pc.beats.conv_pos_groups, b["conv_pos_groups"]),
        "beats_config.num_buckets": (pc.beats.rel_pos_buckets, b["num_buckets"]),
        "beats_config.max_distance": (pc.beats.rel_pos_max_distance, b["max_distance"]),
        "beats_config.gru_rel_pos": (pc.beats.gated_rel_pos, b["gru_rel_pos"]),
        "qformer_config.hidden_size": (pc.qformer.dim, q["hidden_size"]),
        "qformer_config.num_hidden_layers": (pc.qformer.n_layers, q["num_hidden_layers"]),
        "qformer_config.num_attention_heads": (pc.qformer.n_heads, q["num_attention_heads"]),
        "qformer_config.intermediate_size": (pc.qformer.mlp_ratio * pc.qformer.dim,
                                             q["intermediate_size"]),
        "qformer_config.layer_norm_eps": (pc.qformer.ln_eps, q["layer_norm_eps"]),
        "qformer_config.num_speech_query_token": (pc.qformer.n_query,
                                                  q["num_speech_query_token"]),
        "qformer_config.second_per_window": (pc.qformer.window, window(cfg)),
        "ln_speech, ln_audio": (pc.qformer.norm_widths,
                                (w["d_model"], b["encoder_embed_dim"])),
        "text_config.num_hidden_layers": (pc.llm.n_layers, t["num_hidden_layers"]),
        "text_config.hidden_size": (pc.llm.dim, t["hidden_size"]),
        "text_config.num_attention_heads": (pc.llm.n_heads, t["num_attention_heads"]),
        "text_config.num_key_value_heads": (pc.llm.n_kv_heads, t["num_key_value_heads"]),
        "text_config.intermediate_size": (pc.llm.hidden_dim, t["intermediate_size"]),
        "text_config.vocab_size": (pc.llm.vocab_size, t["vocab_size"]),
        "text_config.rope_theta": (pc.llm.rope_theta, t["rope_theta"]),
        "text_config.rms_norm_eps": (pc.llm.rms_eps, t["rms_norm_eps"]),
        "text_config.qkv_bias": (pc.llm.qkv_bias, t["qkv_bias"]),
        "speech_llama_proj": (pc.qformer.llm_dim, t["hidden_size"]),
        "torch_dtype": (pc.compute_dtype, W.DTYPES[cfg["torch_dtype"]]),
    }
    return [k for k, (port_value, file_value) in pairs.items() if port_value != file_value]


def dims(cfg: Dict) -> Dict[str, int]:
    w, b, q, t = (cfg[k] for k in ("whisper_config", "beats_config", "qformer_config",
                                  "text_config"))
    return {
        "mels": w["num_mel_bins"], "d": w["d_model"], "enc_layers": w["encoder_layers"],
        "enc_heads": w["encoder_attention_heads"], "enc_ffn": w["encoder_ffn_dim"],
        "frames": w["max_source_positions"],
        "fbank": b["n_fbank"], "patch": b["input_patch_size"], "be": b["embed_dim"],
        "bd": b["encoder_embed_dim"], "b_layers": b["encoder_layers"],
        "b_heads": b["encoder_attention_heads"], "b_ffn": b["encoder_ffn_embed_dim"],
        "conv_pos": b["conv_pos"], "conv_groups": b["conv_pos_groups"],
        "buckets": b["num_buckets"], "b_tokens": beats_tokens(cfg),
        "qd": q["hidden_size"], "q_layers": q["num_hidden_layers"],
        "q_ffn": q["intermediate_size"], "n_query": q["num_speech_query_token"],
        "window": window(cfg), "windows": (WHISPER_FRAMES - window(cfg)) // window(cfg) + 1,
        "D": t["hidden_size"], "L": t["num_hidden_layers"], "H": t["num_attention_heads"],
        "Hkv": t["num_key_value_heads"], "hd": t["hidden_size"] // t["num_attention_heads"],
        "F": t["intermediate_size"], "V": t["vocab_size"],
    }


def _w(i, o, lead=()):
    return (lead + (i, o), ("normal", i ** -0.5))


def _bias(*shape):
    return (shape, ("normal", 0.02))


def _ones(*shape):
    return (shape, ("ones",))


def _stacked(prefix, leaves):
    return [(prefix + name,) + spec for name, spec in leaves]


def leaf_plan(cfg: Dict):
    """[(path, shape, init)] in drawing order; init is ("normal", std),
    ("ones",) or ("sinusoids",)."""
    n = dims(cfg)
    d, Le, D, L = n["d"], n["enc_layers"], n["D"], n["L"]
    bd, Lb, qd, Lq = n["bd"], n["b_layers"], n["qd"], n["q_layers"]
    ew = d + bd
    plan = [
        (("whisper", "conv1", "w"), (3, n["mels"], d), ("normal", (3 * n["mels"]) ** -0.5)),
        (("whisper", "conv1", "b"),) + _bias(d),
        (("whisper", "conv2", "w"), (3, d, d), ("normal", (3 * d) ** -0.5)),
        (("whisper", "conv2", "b"),) + _bias(d),
        (("whisper", "positions"), (n["frames"], d), ("sinusoids",)),
    ]
    plan += _stacked(("whisper", "blocks"), [
        (("ln1", "w"), _ones(Le, d)), (("ln1", "b"), _bias(Le, d)),
        (("attn", "wq"), _w(d, d, (Le,))), (("attn", "bq"), _bias(Le, d)),
        (("attn", "wk"), _w(d, d, (Le,))),
        (("attn", "wv"), _w(d, d, (Le,))), (("attn", "bv"), _bias(Le, d)),
        (("attn", "wo"), _w(d, d, (Le,))), (("attn", "bo"), _bias(Le, d)),
        (("ln2", "w"), _ones(Le, d)), (("ln2", "b"), _bias(Le, d)),
        (("mlp", "w1"), _w(d, n["enc_ffn"], (Le,))), (("mlp", "b1"), _bias(Le, n["enc_ffn"])),
        (("mlp", "w2"), _w(n["enc_ffn"], d, (Le,))), (("mlp", "b2"), _bias(Le, d)),
    ])
    plan += [
        (("whisper", "ln_post", "w"), (d,), ("normal", 0.5)),
        (("whisper", "ln_post", "b"),) + _bias(d),
        (("qformer", "query_tokens"), (n["n_query"], qd), ("normal", 1.0)),
        (("qformer", "ln_input", "w"),) + _ones(ew),
        (("qformer", "ln_input", "b"),) + _bias(ew),
    ]

    def attn(name, kv_in):
        return [((name, "wq"), _w(qd, qd, (Lq,))), ((name, "bq"), _bias(Lq, qd)),
                ((name, "wk"), _w(kv_in, qd, (Lq,))), ((name, "bk"), _bias(Lq, qd)),
                ((name, "wv"), _w(kv_in, qd, (Lq,))), ((name, "bv"), _bias(Lq, qd)),
                ((name, "wo"), _w(qd, qd, (Lq,))), ((name, "bo"), _bias(Lq, qd))]

    plan += _stacked(("qformer", "layers"), attn("self_attn", qd) + [
        (("ln_self", "w"), _ones(Lq, qd)), (("ln_self", "b"), _bias(Lq, qd)),
    ] + attn("cross_attn", ew) + [
        (("ln_cross", "w"), _ones(Lq, qd)), (("ln_cross", "b"), _bias(Lq, qd)),
        (("mlp", "w1"), _w(qd, n["q_ffn"], (Lq,))), (("mlp", "b1"), _bias(Lq, n["q_ffn"])),
        (("mlp", "w2"), _w(n["q_ffn"], qd, (Lq,))), (("mlp", "b2"), _bias(Lq, qd)),
        (("ln_mlp", "w"), _ones(Lq, qd)), (("ln_mlp", "b"), _bias(Lq, qd)),
    ])
    plan += [(("qformer", "proj", "w"),) + _w(qd, D), (("qformer", "proj", "b"),) + _bias(D)]
    p, be, cg = n["patch"], n["be"], bd // n["conv_groups"]
    hd_b = bd // n["b_heads"]
    plan += [
        (("beats", "patch_embed", "w"), (p, p, 1, be), ("normal", (p * p) ** -0.5)),
        (("beats", "patch_embed", "b"),) + _bias(be),
        (("beats", "ln_patch", "w"),) + _ones(be),
        (("beats", "ln_patch", "b"),) + _bias(be),
        (("beats", "post_proj", "w"),) + _w(be, bd),
        (("beats", "post_proj", "b"),) + _bias(bd),
        (("beats", "conv_pos", "w"), (n["conv_pos"], cg, bd),
         ("normal", (n["conv_pos"] * cg) ** -0.5)),
        (("beats", "conv_pos", "b"),) + _bias(bd),
        (("beats", "ln_pre", "w"),) + _ones(bd),
        (("beats", "ln_pre", "b"),) + _bias(bd),
    ]
    plan += _stacked(("beats", "layers"), [
        (("attn", "wq"), _w(bd, bd, (Lb,))), (("attn", "bq"), _bias(Lb, bd)),
        (("attn", "wk"), _w(bd, bd, (Lb,))), (("attn", "bk"), _bias(Lb, bd)),
        (("attn", "wv"), _w(bd, bd, (Lb,))), (("attn", "bv"), _bias(Lb, bd)),
        (("attn", "wo"), _w(bd, bd, (Lb,))), (("attn", "bo"), _bias(Lb, bd)),
        (("attn", "grep_w"), _w(hd_b, 8, (Lb,))), (("attn", "grep_b"), _bias(Lb, 8)),
        (("attn", "grep_a"), _ones(Lb, n["b_heads"])),
        (("ln_attn", "w"), _ones(Lb, bd)), (("ln_attn", "b"), _bias(Lb, bd)),
        (("mlp", "w1"), _w(bd, n["b_ffn"], (Lb,))), (("mlp", "b1"), _bias(Lb, n["b_ffn"])),
        (("mlp", "w2"), _w(n["b_ffn"], bd, (Lb,))), (("mlp", "b2"), _bias(Lb, bd)),
        (("ln_mlp", "w"), _ones(Lb, bd)), (("ln_mlp", "b"), _bias(Lb, bd)),
    ])
    plan.append((("beats", "rel_bias"), (n["buckets"], n["b_heads"]), ("normal", 1.0)))
    q_out, kv_out = n["H"] * n["hd"], n["Hkv"] * n["hd"]
    lora = cfg.get("lora")
    if lora:
        r = lora["rank"]
        outs = {"wq": q_out, "wk": kv_out, "wv": kv_out}
        for tgt in lora["targets"]:
            plan.append((("lora", tgt, "a"), (L, D, r), ("normal", D ** -0.5)))
            plan.append((("lora", tgt, "b"), (L, r, outs[tgt]), ("normal", 0.01)))
    plan.append((("llm", "tok_embed"), (n["V"], D), ("normal", 1.0)))
    plan += _stacked(("llm", "layers"), [
        (("attn", "wq"), _w(D, q_out, (L,))), (("attn", "wk"), _w(D, kv_out, (L,))),
        (("attn", "wv"), _w(D, kv_out, (L,))), (("attn", "wo"), _w(q_out, D, (L,))),
        (("mlp", "w_gate"), _w(D, n["F"], (L,))), (("mlp", "w_up"), _w(D, n["F"], (L,))),
        (("mlp", "w_down"), _w(n["F"], D, (L,))),
        (("ln_attn",), _ones(L, D)), (("ln_mlp",), _ones(L, D)),
    ])
    if cfg["text_config"]["qkv_bias"]:
        plan += _stacked(("llm", "layers"), [(("attn", "bq"), _bias(L, q_out)),
                                             (("attn", "bk"), _bias(L, kv_out)),
                                             (("attn", "bv"), _bias(L, kv_out))])
    plan.append((("llm", "final_norm"),) + _ones(D))
    if not cfg["text_config"]["tie_word_embeddings"]:
        plan.append((("llm", "lm_head"),) + _w(D, n["V"]))
    return plan


def eval_model(cfg: Dict, spec: Dict, params: Dict[str, Any], device):
    """The port's SALMONN over ``params`` (its decoder quantized in place
    where the file says so), with its static engine and packing: 88
    positions a clip."""
    from icl_speech_text_llm_tpu_torch.models.factory import SalmonnModel
    from icl_speech_text_llm_tpu_torch.utils.tokenization import get_tokenizer

    pc = port_config(cfg)
    port.quantize(cfg, params["llm"])
    tok = get_tokenizer()
    return SalmonnModel(pc, params, tok, pack_config(spec, pc), port.generation(cfg, spec, tok),
                        device)


def pack_config(spec: Dict, pc):
    return port.pack_config(spec, pc.audio_tokens_per_slot)


def train_loss():
    raise NotImplementedError("the benchmark trains no SALMONN cell")


def samples(traffic, batch) -> List:
    """Raw requests as the port's ``ICLSample``s, the prompt built by the
    port's ``build_default_prompt``."""
    from icl_speech_text_llm_tpu_torch.data.collate import ICLSample
    from icl_speech_text_llm_tpu_torch.data.prompts import build_default_prompt

    task = traffic.task
    out = []
    for req in batch:
        examples = [{"label": e.label, "text": e.text} for e in req.examples]
        plan = build_default_prompt(task["template"], req.text, examples,
                                    input_mode=task["input_mode"],
                                    fewshot_mode=task["fewshot_mode"])
        audio = {}
        for kind, i in plan.slots:
            clip = req.main_clip if kind == "main" else req.examples[i].clip
            audio[(kind, i)] = traffic.wav(clip)
        out.append(ICLSample(plan=plan, completion=req.label, slot_audio=audio, extras={}))
    return out


def encoders(cfg: Dict, w: R.Work, clips: int) -> None:
    """The forward work of ``clips`` clips, each padded to 30 s: Whisper
    over 1500 frames with every key (K2), BEATs over its 1496 tokens with
    the gated bias (K3), the Q-Former's windows and the projection. The
    bias table (bf16, a head's (T, T)) is read once a layer over the
    batch's clips, as one launch takes them all."""
    n = dims(cfg)
    d, ffn, H, Le, T = n["d"], n["enc_ffn"], n["enc_heads"], n["enc_layers"], WHISPER_FRAMES
    whisper = (2.0 * 2 * T * 3 * n["mels"] * d + 2.0 * T * 3 * d * d
               + Le * 2.0 * T * (4 * d * d + 2 * d * ffn) + Le * 4.0 * d * T * T)
    bd, Hb, Lb, Tb, p = n["bd"], n["b_heads"], n["b_layers"], n["b_tokens"], n["patch"]
    hdb = bd // Hb
    beats = (2.0 * Tb * (p * p * n["be"] + n["be"] * bd)
             + 2.0 * Tb * n["conv_pos"] * (bd // n["conv_groups"]) * bd
             + Lb * 2.0 * Tb * (4 * bd * bd + 2 * bd * n["b_ffn"]))
    gate = 2.0 * Tb * Hb * hdb * 8  # the gate's projection, inside K3
    qd, win, ew = n["qd"], n["window"], n["d"] + n["bd"]
    rows = n["windows"] * n["n_query"]
    qformer = (n["q_layers"] * 2.0 * rows * (4 * qd * qd + 2 * qd * qd + 2 * qd * n["q_ffn"])
               + n["q_layers"] * 2.0 * n["windows"] * win * 2 * ew * qd
               + n["q_layers"] * 4.0 * qd * rows * (n["n_query"] + win)
               + 2.0 * rows * qd * n["D"])
    for _ in range(clips):
        w.model_flops += whisper + beats + Lb * (4.0 * bd * Tb * Tb + gate) + qformer
        fl, by = R.attention_fwd(H, H, d // H, T, T * T, T)
        w.add("tower_attention", Le * fl, Le * by)
        fl, by = R.attention_fwd(Hb, Hb, hdb, Tb, Tb * Tb, Tb)
        xh = Tb * bd * R.BF16  # the gate's input, the layer's input in heads
        w.add("beats_attention", Lb * (fl + gate), Lb * (by + xh))
    if clips:
        w.add("beats_attention", 0.0, Lb * Hb * Tb * Tb * R.BF16)


def eval_work(cfg: Dict, w: R.Work, clip_samples: Sequence[int],
              prompts: Sequence[int], new_tokens: int) -> None:
    n = dims(cfg)
    encoders(cfg, w, len(clip_samples))
    work.decoder_prefill(cfg, n, w, prompts)
    work.decode(cfg, n, w, prompts, new_tokens)


def train_work(cfg: Dict, w: R.Work, clip_samples: Sequence[int],
               positions: Sequence[int]) -> None:
    raise NotImplementedError("the benchmark trains no SALMONN cell")
