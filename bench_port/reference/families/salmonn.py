"""Plain SALMONN in float32, written from the published model
(github.com/bytedance/SALMONN, ``models/salmonn.py``; BEATs from
microsoft/unilm's ``BEATs/BEATs.py`` and ``backbone.py``; the Q-Former is
LAVIS's BERT with cross-attention in every layer): the repository's ICL
prompt, then for every clip Whisper's encoder with its final norm and
BEATs, each normalised on its own (``ln_speech``, ``ln_audio``), BEATs
padded to Whisper's 1500 frames and the two concatenated, the window
Q-Former (one query for each window of 17 frames, 88 windows), the
projection, and Vicuna (LLaMA: RMSNorm, rotary attention, SwiGLU) with
LoRA on wq and wv. The tree is the one ``benchlib/families/salmonn.py``
draws.

BEATs, as written here: Kaldi's fbank (25 ms frames, 10 ms hop, DC
removed, pre-emphasis 0.97, Povey window, a 512-point power spectrum, 128
triangular filters on the mel scale from 20 Hz to 8 kHz, log floored at
float32's epsilon) of the clip scaled to 16-bit range, normalised by
(x − 15.41663) / (2 · 6.55582); a 16 × 16 patch convolution to 512, tokens
in time-major order; LayerNorm; ``post_extract_proj`` to 768; a grouped
convolutional position embedding (kernel 128, 16 groups, the last frame
dropped, GELU) added, then LayerNorm; 12 post-LN layers with deep-norm
residuals (α = (2 · 12)^¼) whose attention adds a relative-position bias
(T5 buckets, 320, max distance 800; layer 0's table shared by all)
scaled for each query row by the WavLM gate
σ(Σ g[:4]) · (σ(Σ g[4:]) · a_h − 1) + 2, g = grep_linear(row in heads).

Departures from the published model, each as the port runs it:

- every clip is padded to 30 s before both encoders, BEATs included, and
  no padding is masked (published SALMONN pads BEATs' input to the
  batch's longest clip and masks the rest);
- the gate reads the layer's input split into heads, as WavLM's fast path
  and transformers' WavLM port compute it;
- the prompt is the repository's ICL prompt (``<Speech><Example{i}></Speech>``
  exemplars, then the query and ``Output:``), each segment tokenized on its
  own without BOS, and not SALMONN's ``USER: … ASSISTANT:`` template;
- the tokenizer is the repository's (36764 ids); ids past Vicuna's 32000
  read the table's last row, as the port's embedding does;
- the BERT embeddings' LayerNorm over the constant query token is folded
  into the tree's ``query_tokens`` (as the port's converter folds it);
- GELU is exact here; the port computes the tanh form in bfloat16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference import model as M
from reference.text import Tokenizer

FBANK_MEAN, FBANK_STD = 15.41663, 6.55582
WHISPER_FRAMES = 1500
#: prompt positions a clip takes: one query for each of the Q-Former's 88
#: windows of 17 frames
CLIP_POSITIONS = 88


def salmonn_segments(template: str, examples: Sequence[Dict], fewshot_mode: str) -> List[str]:
    """The repository's ICL prompt for a speech query (input mode
    ``speech_only``): the template, the exemplars (each a clip, or a
    transcript, then its label), the query's clip, ``Output:``. → the text
    segments around the clips."""
    head = f"{template}\n"
    if examples:
        head += "\nHere are few examples to learn from:\n"
    segments: List[str] = []
    text = head
    for i, ex in enumerate(examples):
        sep = "\n\n" if i else ""
        if fewshot_mode == "speech":
            segments.append(text + sep + "<Speech>")
            text = f"</Speech>\nOutput: {ex['label']}"
        else:
            text += f"{sep}Text: {ex['text']}\nOutput: {ex['label']}"
    if examples:
        text += "\n\n"
    segments.append(text + "Now analyze this input:\n<Speech>")
    segments.append("</Speech>\nOutput:")
    return segments


# --------------------------------------------------------------------------
# BEATs
# --------------------------------------------------------------------------


def kaldi_fbank(wavs: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(N, n) audio in 16-bit range → (N, frames, n_mels) Kaldi log mel
    filterbank energies (torchaudio's ``compliance.kaldi.fbank`` defaults),
    computed in float64 and returned in float32."""
    frame, hop, nfft, sr = 400, 160, 512, 16_000
    n = wavs.shape[-1]
    frames = 1 + (n - frame) // hop
    idx = (torch.arange(frames, device=wavs.device)[:, None] * hop
           + torch.arange(frame, device=wavs.device)[None])
    x = wavs.double()[:, idx]
    x = x - x.mean(dim=-1, keepdim=True)
    x = x - 0.97 * torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    t = torch.arange(frame, dtype=torch.float64, device=wavs.device)
    x = x * (0.5 - 0.5 * torch.cos(2 * math.pi * t / (frame - 1))) ** 0.85
    spec = torch.fft.rfft(x, n=nfft)
    power = spec.real ** 2 + spec.imag ** 2

    def mel(f):
        return 1127.0 * torch.log(1.0 + f / 700.0)

    lo = mel(torch.tensor(20.0, dtype=torch.float64))
    hi = mel(torch.tensor(sr / 2, dtype=torch.float64))
    step = (hi - lo) / (n_mels + 1)
    b = torch.arange(n_mels, dtype=torch.float64)[:, None]
    left, centre, right = lo + b * step, lo + (b + 1) * step, lo + (b + 2) * step
    bins = mel(sr / nfft * torch.arange(nfft // 2, dtype=torch.float64))[None]
    banks = torch.clamp(torch.minimum((bins - left) / (centre - left),
                                      (right - bins) / (right - centre)), min=0.0)
    banks = F.pad(banks, (0, 1)).to(wavs.device)  # the Nyquist bin weighs nothing
    energy = power @ banks.T
    return torch.log(torch.clamp(energy, min=float(np.finfo(np.float32).eps))).float()


def rel_buckets(t: int, num_buckets: int, max_distance: int, device) -> torch.Tensor:
    """BEATs' bidirectional relative-position buckets of a (t, t) attention."""
    rel = (torch.arange(t, device=device)[None, :] - torch.arange(t, device=device)[:, None])
    half = num_buckets // 2
    out = (rel > 0).long() * half
    rel = rel.abs()
    exact = half // 2
    large = exact + (torch.log(rel.float().clamp(min=1) / exact) / math.log(max_distance / exact)
                     * (half - exact)).long()
    return out + torch.where(rel < exact, rel, torch.clamp(large, max=half - 1))


def beats(cfg: Dict, tree: Dict, wavs: torch.Tensor,
          precision: M.Precision = M.Precision()) -> torch.Tensor:
    """(N, 30 s) audio in [-1, 1] → (N, tokens, 768) BEATs features."""
    b = cfg["beats_config"]
    spec, act = precision.tower, precision.act
    fb = (kaldi_fbank(wavs * 2 ** 15, b["n_fbank"]) - FBANK_MEAN) / (2 * FBANK_STD)
    N = fb.shape[0]
    p = b["input_patch_size"]
    pe = tree["patch_embed"]
    w = pe["w"].float().permute(3, 2, 0, 1)  # (e, 1, p, p)
    if spec is not None:
        w = M.fake_quant(w.reshape(w.shape[0], -1).T, spec).T.reshape(w.shape)
    x = F.conv2d(M.act_quant(fb, act)[:, None], w, pe["b"].float(), stride=p)  # (N, e, T/p, F/p)
    x = x.flatten(2).transpose(1, 2)
    x = M.layer_norm(x, tree["ln_patch"]["w"], tree["ln_patch"]["b"])
    x = M.lin(x, tree["post_proj"]["w"], tree["post_proj"]["b"], spec, act)
    cp = tree["conv_pos"]
    k, groups = b["conv_pos"], b["conv_pos_groups"]
    cw = cp["w"].float().permute(2, 1, 0)  # (out, in / groups, k)
    if spec is not None:
        cw = M.fake_quant(cw.reshape(cw.shape[0], -1).T, spec).T.reshape(cw.shape)
    conv = F.conv1d(M.act_quant(x, act).transpose(1, 2), cw, cp["b"].float(), padding=k // 2,
                    groups=groups).transpose(1, 2)
    if k % 2 == 0:
        conv = conv[:, :-1]
    x = M.layer_norm(x + F.gelu(conv), tree["ln_pre"]["w"], tree["ln_pre"]["b"])
    T, d = x.shape[1], x.shape[2]
    H = b["encoder_attention_heads"]
    hd = d // H
    table = tree["rel_bias"].float()[rel_buckets(T, b["num_buckets"], b["max_distance"],
                                                 x.device)].permute(2, 0, 1)  # (H, T, T)
    alpha = (2.0 * b["encoder_layers"]) ** 0.25
    lay = tree["layers"]
    for l in range(b["encoder_layers"]):
        a = {k: v[l] for k, v in lay["attn"].items()}
        q, kk, v = (M.lin(x, a[wn], a[bn], spec, act).view(N, T, H, hd).transpose(1, 2)
                    for wn, bn in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        g = x.view(N, T, H, hd).transpose(1, 2) @ a["grep_w"].float() + a["grep_b"].float()
        g = torch.sigmoid(g.view(N, H, T, 2, 4).sum(-1))
        gate = g[..., 0] * (g[..., 1] * a["grep_a"].float()[None, :, None] - 1.0) + 2.0
        s = (q @ kk.transpose(-1, -2)) / math.sqrt(hd) + gate[..., None] * table[None]
        o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(N, T, d)
        x = M.layer_norm(x * alpha + M.lin(o, a["wo"], a["bo"], spec, act),
                         lay["ln_attn"]["w"][l], lay["ln_attn"]["b"][l])
        m = {k: v[l] for k, v in lay["mlp"].items()}
        h = M.lin(F.gelu(M.lin(x, m["w1"], m["b1"], spec, act)), m["w2"], m["b2"], spec, act)
        x = M.layer_norm(x * alpha + h, lay["ln_mlp"]["w"][l], lay["ln_mlp"]["b"][l])
    return x


# --------------------------------------------------------------------------
# The window Q-Former
# --------------------------------------------------------------------------


def _bert_attention(p: Dict, l: int, q_in, kv_in, heads: int, spec, act):
    n, tq, d = q_in.shape
    tk, hd = kv_in.shape[1], d // heads
    q = M.lin(q_in, p["wq"][l], p["bq"][l], spec, act).view(n, tq, heads, hd).transpose(1, 2)
    k = M.lin(kv_in, p["wk"][l], p["bk"][l], spec, act).view(n, tk, heads, hd).transpose(1, 2)
    v = M.lin(kv_in, p["wv"][l], p["bv"][l], spec, act).view(n, tk, heads, hd).transpose(1, 2)
    o = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1) @ v
    return M.lin(o.transpose(1, 2).reshape(n, tq, d), p["wo"][l], p["bo"][l], spec, act)


def qformer(cfg: Dict, tree: Dict, speech: torch.Tensor, audio: torch.Tensor,
            precision: M.Precision = M.Precision()) -> torch.Tensor:
    """Whisper's (N, 1500, 1280) and BEATs' (N, T, 768) features → (N,
    windows · queries, D): ``ln_speech`` and ``ln_audio`` (the halves of
    ``ln_input``), BEATs padded to 1500 frames, concatenated, cut into
    windows of ``round(1500 · second_per_window / 30)`` frames, the BERT
    layers over the query token with each window as its cross-attention
    memory, then the projection."""
    q_cfg = cfg["qformer_config"]
    spec, act = precision.tower, precision.act
    ln = tree["ln_input"]
    ws = speech.shape[-1]
    speech = M.layer_norm(speech, ln["w"][:ws], ln["b"][:ws])
    audio = M.layer_norm(audio, ln["w"][ws:], ln["b"][ws:])
    audio = F.pad(audio, (0, 0, 0, speech.shape[1] - audio.shape[1]))
    x = torch.cat([speech, audio], dim=-1)
    N, T, C = x.shape
    win = round(WHISPER_FRAMES * q_cfg["second_per_window"] / 30.0)
    windows = x.unfold(1, win, win).permute(0, 1, 3, 2).reshape(-1, win, C)  # (N · n_w, win, C)
    eps = q_cfg["layer_norm_eps"]
    heads = q_cfg["num_attention_heads"]
    q = tree["query_tokens"].float()[None].expand(windows.shape[0], -1, -1)
    lay = tree["layers"]
    for l in range(q_cfg["num_hidden_layers"]):
        def norm(h, name):
            return M.layer_norm(h, lay[name]["w"][l], lay[name]["b"][l], eps)

        q = norm(q + _bert_attention(lay["self_attn"], l, q, q, heads, spec, act), "ln_self")
        q = norm(q + _bert_attention(lay["cross_attn"], l, q, windows, heads, spec, act),
                 "ln_cross")
        m = {k: v[l] for k, v in lay["mlp"].items()}
        h = M.lin(F.gelu(M.lin(q, m["w1"], m["b1"], spec, act)), m["w2"], m["b2"], spec, act)
        q = norm(q + h, "ln_mlp")
    out = M.lin(q, tree["proj"]["w"], tree["proj"]["b"], spec, act)
    return out.reshape(N, -1, out.shape[-1])


def encode_clips(cfg: Dict, tree: Dict, wavs: Sequence[np.ndarray], device,
                 precision: M.Precision = M.Precision()) -> torch.Tensor:
    """Raw clips → (N, ``CLIP_POSITIONS``, D) prompt embeddings."""
    w = cfg["whisper_config"]
    batch = M.clip_batch(wavs, device)
    mel = M.log_mel(batch, w["num_mel_bins"]).transpose(1, 2)
    enc = tree["whisper"]
    speech = M.whisper_encoder(enc, mel, w["encoder_attention_heads"], w["encoder_layers"],
                               precision)
    speech = M.layer_norm(speech, enc["ln_post"]["w"], enc["ln_post"]["b"])
    out = qformer(cfg, tree["qformer"], speech, beats(cfg, tree["beats"], batch, precision),
                  precision)
    if out.shape[1] != CLIP_POSITIONS:
        raise ValueError(f"the configuration gives {out.shape[1]} positions a clip, the "
                         f"prompt {CLIP_POSITIONS}")
    return out


def _segments(task: Dict, request) -> Tuple[List[str], list]:
    examples = [{"label": e.label, "text": e.text} for e in request.examples]
    segments = salmonn_segments(task["template"], examples, task["fewshot_mode"])
    clips = [e.clip for e in request.examples if e.clip is not None] + [request.main_clip]
    return segments, clips


class Plain:
    """``reference/check.py``'s plain model over a SALMONN tree."""

    def __init__(self, cfg: Dict, tree: Dict):
        t, lora = cfg["text_config"], cfg.get("lora")
        self.cfg, self.tree, self.lora = cfg, tree, tree.get("lora")
        self.sizes = M.DecoderSizes(
            layers=t["num_hidden_layers"], heads=t["num_attention_heads"],
            kv_heads=t["num_key_value_heads"],
            head_dim=t["hidden_size"] // t["num_attention_heads"], rms_eps=t["rms_norm_eps"],
            rope_theta=t["rope_theta"], lora_scaling=lora["alpha"] / lora["rank"] if lora else 0.0)

    def prompt_embeds(self, task: Dict, request, wav: Callable, tok: Tokenizer, device,
                      precision: M.Precision = M.Precision()) -> torch.Tensor:
        """A request's prompt as (P, D) float32 embeddings: text segments and
        clips in turn, each clip ``CLIP_POSITIONS`` rows."""
        segments, clips = _segments(task, request)
        audio = encode_clips(self.cfg, self.tree, [wav(c) for c in clips], device, precision)
        parts = []
        for i, seg in enumerate(segments):
            parts.append(self.embed(tok.encode(seg), device))
            if i < len(audio):
                parts.append(audio[i])
        return torch.cat(parts, dim=0)

    def embed(self, ids: Sequence[int], device) -> torch.Tensor:
        return M.embed(self.tree["llm"]["tok_embed"], ids, device)

    def decoder(self, x: torch.Tensor, lora, precision: M.Precision, cached_from=None,
                checkpointed: bool = False) -> torch.Tensor:
        llm = self.tree["llm"]
        return M.decoder(self.sizes, llm["layers"], llm["final_norm"], x, lora, precision,
                         cached_from, checkpointed)

    def logits(self, hidden: torch.Tensor, precision: M.Precision) -> torch.Tensor:
        return M.logits(self.tree["llm"]["lm_head"], hidden, precision)


def prompt_length(task: Dict, request, tok: Tokenizer) -> Tuple[int, int]:
    """(positions, text tokens) of a request's prompt."""
    segments, clips = _segments(task, request)
    text = sum(len(tok.encode(s)) for s in segments)
    return text + len(clips) * CLIP_POSITIONS, text
