"""Plain building blocks in float32, written from the published models, that
each family's reference (``reference/families/<family>.py``) puts
together: Whisper's log-mel, its conv front end and encoder layers (each
clip's keys optionally masked past its frames), and a decoder layer of
RMSNorm, rotary attention with grouped KV heads and optional q/k/v
biases, and SwiGLU. No kernels, no cache, no batching across prompts: one
prompt at a time, the weights of one layer at a time cast to float32.
Each block takes its sizes as arguments and names no model.

Lower precisions are put in by ``Precision``: weight-only integer
quantization (symmetric, round half to even, per output column or per
group of input rows) and a quantized KV cache (one scale per position and
head), which a cached decode would read for every earlier position.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT, HOP = 400, 160
CLIP_SAMPLES = 30 * SAMPLE_RATE
FP8_MAX = 448.0  # e4m3


def full_precision() -> None:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Precision:
    """The weights of each part (None: as given; ("int", bits, group): group
    0 is one scale per output column; ("fp8", 0, 0): e4m3, one scale per
    output column), the inputs of every product (None: float32; ("fp8",):
    e4m3 with one scale a row) and the KV cache's bits (None: exact)."""

    tower: Optional[Tuple] = None
    decoder: Optional[Tuple] = None
    lm_head: Optional[Tuple] = None
    kv_bits: Optional[int] = None
    act: Optional[Tuple] = None


def stated(cfg: Dict) -> Precision:
    """The precision a configuration file states for its weights and cache."""
    q = cfg.get("quant")
    if not q:
        return Precision()
    lm = q["lm_head_bits"]
    return Precision(decoder=("int", q["weight_bits"], q["group"]),
                     lm_head=("int", lm, 0) if lm else None,
                     kv_bits=8 if q.get("kv_int8") else None)


def control(cfg: Dict) -> Precision:
    """The control: each part one precision below the stated one. bfloat16
    products → fp8 (e4m3) weights and inputs; an int8 lm_head and KV cache
    → int4 (the lm_head in groups of the stated size, or of 128); int8
    weights → int4 in groups of 128, int4 weights stay; every bfloat16
    input → fp8."""
    q = cfg.get("quant")
    f8 = ("fp8", 0, 0)
    if not q:
        return Precision(tower=f8, decoder=f8, lm_head=f8, act=("fp8",))
    return Precision(tower=f8, decoder=("int", 4, q["group"] or 128),
                     lm_head=("int", 4, q["group"] or 128) if q["lm_head_bits"] else f8,
                     kv_bits=4 if q.get("kv_int8") else None, act=("fp8",))


def fake_quant(w: torch.Tensor, spec) -> torch.Tensor:
    """(in, out) float32 weight → its dequantized integer copy."""
    if spec is None:
        return w
    kind, bits, group = spec
    if kind == "fp8":
        s = w.abs().amax(dim=0, keepdim=True) / FP8_MAX
        s = torch.where(s == 0, torch.ones_like(s), s)
        return (w / s).to(torch.float8_e4m3fn).float() * s
    top = 2 ** (bits - 1) - 1
    if group:  # the largest group up to ``group`` that divides half the input rows
        half = w.shape[0] // 2
        group = next(g for g in range(min(group, half), 1, -1) if half % g == 0)
        wg = w.reshape(w.shape[0] // group, group, w.shape[1])
        s = wg.abs().amax(dim=1, keepdim=True) / top
        s = torch.where(s == 0, torch.ones_like(s), s)
        return (torch.clamp(torch.round(wg / s), -top, top) * s).reshape(w.shape)
    s = w.abs().amax(dim=0, keepdim=True) / top
    s = torch.where(s == 0, torch.ones_like(s), s)
    return torch.clamp(torch.round(w / s), -top, top) * s


def act_quant(x: torch.Tensor, act) -> torch.Tensor:
    """A product's input rows → their dequantized fp8 copy, one scale a row."""
    if act is None:
        return x
    s = x.abs().amax(dim=-1, keepdim=True) / FP8_MAX
    s = torch.where(s == 0, torch.ones_like(s), s)
    return (x / s).to(torch.float8_e4m3fn).float() * s


def kv_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """(…, hd) rows → their dequantized copy, one scale a row."""
    top = 2 ** (bits - 1) - 1
    s = x.abs().amax(dim=-1, keepdim=True) / top
    safe = torch.where(s == 0, torch.ones_like(s), s)
    return torch.clamp(torch.round(x / safe), -top, top) * s


# --------------------------------------------------------------------------
# Audio
# --------------------------------------------------------------------------


def _mel_filters(n_mels: int) -> np.ndarray:
    """Slaney-scale, Slaney-normalized triangular filters over the 201 FFT
    bins of 0-8 kHz, (201, n_mels) (librosa's ``filters.mel`` defaults)."""

    def to_mel(f):
        f = np.asarray(f, np.float64)
        lin = 3.0 * f / 200.0
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) * 27.0 / np.log(6.4), lin)

    def to_hz(m):
        m = np.asarray(m, np.float64)
        lin = 200.0 * m / 3.0
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), lin)

    bins = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    edges = to_hz(np.linspace(to_mel(0.0), to_mel(8000.0), n_mels + 2))
    fb = np.zeros((bins.size, n_mels))
    for m in range(n_mels):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        rise = (bins - lo) / (mid - lo)
        fall = (hi - bins) / (hi - mid)
        fb[:, m] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (hi - lo)
    return fb.astype(np.float32)


def log_mel(wavs: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(N, n ≤ 30 s) 16 kHz audio → (N, n_mels, 3000) Whisper log-mel: the
    clip zero-padded to 30 s, a centred periodic-Hann STFT (reflect
    padding, the last frame dropped), power, mel, log10 floored at 1e-10
    and at 8 below the clip's peak, then (x + 4) / 4."""
    x = F.pad(wavs.float(), (0, CLIP_SAMPLES - wavs.shape[-1]))
    spec = torch.stft(x, N_FFT, HOP, window=torch.hann_window(N_FFT, device=x.device),
                      center=True, pad_mode="reflect", return_complex=True)[..., :-1]
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(_mel_filters(n_mels)).to(x.device)
    mel = torch.einsum("nft,fm->nmt", power, fb)
    logs = torch.log10(torch.clamp(mel, min=1e-10))
    logs = torch.maximum(logs, logs.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (logs + 4.0) / 4.0


def audio_frames(n_samples: int) -> int:
    """Valid encoder frames of a clip: its mel frames, then the stride-2 conv."""
    return (n_samples // HOP - 1) // 2 + 1


def layer_norm(x, w, b, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), w.float(), b.float(), eps)


def lin(x, w, b=None, spec=None, act=None):
    y = act_quant(x, act) @ fake_quant(w.float(), spec)
    return y if b is None else y + b.float()


def clip_batch(wavs: Sequence[np.ndarray], device) -> torch.Tensor:
    """Raw clips → (N, 30 s) float32, each zero-padded."""
    batch = torch.zeros((len(wavs), CLIP_SAMPLES), dtype=torch.float32, device=device)
    for i, w in enumerate(wavs):
        batch[i, :len(w)] = torch.as_tensor(np.asarray(w, np.float32), device=device)
    return batch


def whisper_encoder(enc: Dict, mel: torch.Tensor, heads: int, n_layers: int,
                    precision: Precision = Precision(),
                    lens: Optional[Sequence[int]] = None) -> torch.Tensor:
    """(N, 3000, mels) log-mel → (N, 1500, d): Whisper's two convolutions
    (the second of stride 2) with GELU, the sinusoid positions and
    ``n_layers`` pre-norm layers, before ``ln_post``. ``lens``: each clip's
    samples, its keys masked past ``audio_frames``; None: every key."""
    spec, act = precision.tower, precision.act

    def conv(x, p, stride):
        w = p["w"].float().permute(2, 1, 0)  # (out, in, 3)
        if spec is not None:
            w = fake_quant(w.reshape(w.shape[0], -1).T, spec).T.reshape(w.shape)
        return F.conv1d(act_quant(x, act).transpose(1, 2), w, p["b"].float(), stride=stride,
                        padding=1).transpose(1, 2)

    x = F.gelu(conv(mel, enc["conv1"], 1))
    x = F.gelu(conv(x, enc["conv2"], 2))
    x = x + enc["positions"].float()[None]
    N, T, d = x.shape
    H = heads
    key_ok = None
    if lens is not None:
        frames = torch.tensor([audio_frames(m) for m in lens], device=x.device)
        key_ok = torch.arange(T, device=x.device)[None, :] < frames[:, None]  # (N, T)
    blocks = enc["blocks"]
    for l in range(n_layers):
        def p(*path):
            node = blocks
            for k in path:
                node = node[k]
            return node[l]

        h = layer_norm(x, p("ln1", "w"), p("ln1", "b"))
        q = lin(h, p("attn", "wq"), p("attn", "bq"), spec, act)
        k = lin(h, p("attn", "wk"), None, spec, act)
        v = lin(h, p("attn", "wv"), p("attn", "bv"), spec, act)
        q, k, v = (t.view(N, T, H, d // H).transpose(1, 2) for t in (q, k, v))
        s = (q @ k.transpose(-1, -2)) / math.sqrt(d // H)
        if key_ok is not None:
            s = s.masked_fill(~key_ok[:, None, None, :], float("-inf"))
        o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(N, T, d)
        x = x + lin(o, p("attn", "wo"), p("attn", "bo"), spec, act)
        h = layer_norm(x, p("ln2", "w"), p("ln2", "b"))
        x = x + lin(F.gelu(lin(h, p("mlp", "w1"), p("mlp", "b1"), spec, act)),
                    p("mlp", "w2"), p("mlp", "b2"), spec, act)
    return x


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class DecoderSizes:
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    rms_eps: float
    rope_theta: float
    lora_scaling: float = 0.0  # alpha / rank


def embed(table: torch.Tensor, ids: Sequence[int], device) -> torch.Tensor:
    """Rows of the embedding table; ids past its end read its last row."""
    idx = torch.as_tensor(list(ids), dtype=torch.long, device=device).clamp(max=table.shape[0] - 1)
    return table[idx].float()


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """(H, T, hd) rotated by position (first half against second half)."""
    T, hd = x.shape[-2], x.shape[-1]
    inv = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    ang = torch.from_numpy(np.arange(T, dtype=np.float64)[:, None] * inv[None, :]).to(x.device)
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def decoder_layer(n: DecoderSizes, lay: Dict, l: int, x: torch.Tensor, lora: Optional[Dict],
                  precision: Precision, cached_from: Optional[int]) -> torch.Tensor:
    """Layer ``l`` of the stacked layer leaves ``lay`` over a whole prompt
    (T, D); a q, k or v bias is used where ``lay["attn"]`` holds one.
    ``cached_from``: queries at or past it are decode steps, which read
    every earlier position's k/v from a cache in ``precision.kv_bits`` and
    their own exactly."""
    spec = precision.decoder
    H, Hkv, hd = n.heads, n.kv_heads, n.head_dim
    T = x.shape[0]
    scaling = n.lora_scaling

    def proj(h, name, bias):
        y = lin(h, lay["attn"][name][l], lay["attn"][bias][l] if bias in lay["attn"] else None,
                spec, precision.act)
        if lora is not None and name in lora:
            y = y + (h @ lora[name]["a"][l].float()) @ lora[name]["b"][l].float() * scaling
        return y

    h = _rms(x, lay["ln_attn"][l], n.rms_eps)
    q = proj(h, "wq", "bq").view(T, H, hd).transpose(0, 1)
    k = proj(h, "wk", "bk").view(T, Hkv, hd).transpose(0, 1)
    v = proj(h, "wv", "bv").view(T, Hkv, hd).transpose(0, 1)
    q, k = _rope(q, n.rope_theta), _rope(k, n.rope_theta)
    rep = H // Hkv
    k, v = k.repeat_interleave(rep, dim=0), v.repeat_interleave(rep, dim=0)
    pos = torch.arange(T, device=x.device)
    causal = pos[None, :] <= pos[:, None]
    s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    cached = None
    if cached_from is not None and precision.kv_bits is not None:
        cached = (pos[None, :] < pos[:, None]) & (pos[:, None] >= cached_from)
        sq = (q @ kv_quant(k, precision.kv_bits).transpose(-1, -2)) / math.sqrt(hd)
        s = torch.where(cached, sq, s)
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    if cached is None:
        o = p @ v
    else:
        o = (p * cached) @ kv_quant(v, precision.kv_bits) + (p * ~cached) @ v
    x = x + lin(o.transpose(0, 1).reshape(T, H * hd), lay["attn"]["wo"][l], None, spec, precision.act)
    h = _rms(x, lay["ln_mlp"][l], n.rms_eps)
    gate = lin(h, lay["mlp"]["w_gate"][l], None, spec, precision.act)
    up = lin(h, lay["mlp"]["w_up"][l], None, spec, precision.act)
    return x + lin(F.silu(gate) * up, lay["mlp"]["w_down"][l], None, spec, precision.act)


def decoder(n: DecoderSizes, lay: Dict, final_norm: torch.Tensor, x: torch.Tensor,
            lora: Optional[Dict] = None, precision: Precision = Precision(),
            cached_from: Optional[int] = None, checkpointed: bool = False) -> torch.Tensor:
    """(T, D) input embeddings → (T, D) final-normed hidden states.
    ``checkpointed``: each layer recomputed in the backward (training)."""
    for l in range(n.layers):
        if checkpointed:
            from torch.utils.checkpoint import checkpoint

            x = checkpoint(decoder_layer, n, lay, l, x, lora, precision, cached_from,
                           use_reentrant=False)
        else:
            x = decoder_layer(n, lay, l, x, lora, precision, cached_from)
    return _rms(x, final_norm, n.rms_eps)


def logits(lm_head: torch.Tensor, hidden: torch.Tensor,
           precision: Precision = Precision()) -> torch.Tensor:
    return lin(hidden, lm_head, None, precision.lm_head, precision.act)
