"""BEATs audio encoder in PyTorch.

Counterpart of ``icl_speech_text_llm_tpu/models/beats.py``: kaldi 128-bin
fbank → normalization → 16×16 patch embedding (a GEMM) → LayerNorm → linear
512→768 → grouped-conv positional embedding → LayerNorm → post-LN layers with
deep-norm residuals and the WavLM gated relative-position bias → (B, 1496,
768) for 30 s. Attention goes through the gated-bias op over the 1496 real
tokens: the kernel masks ragged tiles itself, so there is no 1496→1536
padding of tokens or bias table.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention, gate_rows, gated_bias_attention
from ..ops.mel import framed_dft
from .common import dense_init, full_f32, gelu, layer_at, layer_norm, linear, normal_init

FBANK_MEAN = 15.41663
FBANK_STD = 6.55582


@dataclass(frozen=True)
class BeatsConfig:
    n_fbank: int = 128
    patch: int = 16
    embed_dim: int = 512
    dim: int = 768
    n_heads: int = 12
    n_layers: int = 12
    conv_pos: int = 128
    conv_pos_groups: int = 16
    mlp_ratio: int = 4
    gated_rel_pos: bool = True
    rel_pos_buckets: int = 320
    rel_pos_max_distance: int = 800

    @property
    def deep_norm_alpha(self) -> float:
        return float((2.0 * self.n_layers) ** 0.25)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


BEATS_CONFIGS: Dict[str, BeatsConfig] = {
    "iter3-as2m": BeatsConfig(),
    "tiny-test": BeatsConfig(dim=64, embed_dim=32, n_heads=4, n_layers=2, conv_pos=16,
                             conv_pos_groups=4, rel_pos_buckets=32, rel_pos_max_distance=16),
}


@functools.lru_cache(maxsize=2)
def _kaldi_fused_basis(frame_length: int = 400, nfft: int = 512) -> np.ndarray:
    """The whole kaldi per-frame chain (DC removal, pre-emphasis 0.97 with
    edge duplication, povey window, real DFT) as one (frame_length,
    2·n_freqs) matrix composed in float64."""
    n_freqs = nfft // 2 + 1
    k = np.arange(frame_length, dtype=np.float64)[:, None]
    f = np.arange(n_freqs, dtype=np.float64)[None, :]
    angle = 2.0 * np.pi * k * f / nfft
    basis = np.concatenate([np.cos(angle), -np.sin(angle)], axis=1)
    t = np.arange(frame_length, dtype=np.float64)
    povey = (0.5 - 0.5 * np.cos(2 * np.pi * t / (frame_length - 1))) ** 0.85
    A = np.eye(frame_length)
    A[np.arange(frame_length - 1), np.arange(1, frame_length)] = -0.97
    A[0, 0] = 0.03
    M = A @ (povey[:, None] * basis)
    M = M - M.mean(axis=0, keepdims=True)
    return M.astype(np.float32)


@functools.lru_cache(maxsize=2)
def _htk_mel_bank(n_freqs: int, n_mels: int, sr: int = 16000) -> np.ndarray:
    """Kaldi/HTK mel filter bank (no normalization), (n_freqs, n_mels)."""
    def to_mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    def to_hz(m):
        return 700.0 * (np.exp(m / 1127.0) - 1.0)

    mel_pts = np.linspace(to_mel(20.0), to_mel(sr / 2), n_mels + 2)
    fft_freqs = np.linspace(0, sr / 2, n_freqs)
    fb = np.zeros((n_freqs, n_mels))
    for m in range(n_mels):
        left, center, right = to_hz(mel_pts[m]), to_hz(mel_pts[m + 1]), to_hz(mel_pts[m + 2])
        up = (fft_freqs - left) / (center - left)
        down = (right - fft_freqs) / (right - center)
        fb[:, m] = np.maximum(0, np.minimum(up, down))
    return fb.astype(np.float32)


def kaldi_fbank(wav: torch.Tensor, n_mels: int = 128, frame_length: int = 400,
                hop: int = 160) -> torch.Tensor:
    """Kaldi log-mel fbank (snip_edges): wav (B, n) at 16 kHz in int16 range →
    (B, (n − 400)//160 + 1, n_mels), the framed DFT in full f32."""
    B, n = wav.shape
    n_frames = (n - frame_length) // hop + 1
    nfft = 512
    n_freqs = nfft // 2 + 1
    dev = wav.device
    with full_f32():
        M = torch.from_numpy(_kaldi_fused_basis(frame_length, nfft)).to(dev)
        n_rows = n_frames + frame_length // hop + 1
        sig = F.pad(wav.float(), (0, n_rows * hop - n))
        spec2 = framed_dft(sig.view(B, n_rows, hop), M, n_frames, frame_length, hop)
        power = spec2[..., :n_freqs] ** 2 + spec2[..., n_freqs:] ** 2
        mel = torch.matmul(power, torch.from_numpy(_htk_mel_bank(n_freqs, n_mels)).to(dev))
    return torch.log(torch.clamp(mel, min=1.1920928955078125e-07))


def relative_position_buckets(t: int, num_buckets: int, max_distance: int) -> np.ndarray:
    """T5-style bidirectional relative-position buckets, (t, t) int32."""
    context = np.arange(t, dtype=np.int64)[:, None]
    memory = np.arange(t, dtype=np.int64)[None, :]
    rel = memory - context
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1).astype(np.float64) / max_exact)
        / np.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(is_small, rel, large)
    return buckets.astype(np.int32)


def init_beats(cfg: BeatsConfig, gen: torch.Generator, device, dtype) -> Dict[str, Any]:
    d, L, inner, e = cfg.dim, cfg.n_layers, cfg.mlp_ratio * cfg.dim, cfg.embed_dim

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def dense(i, o, lead=(L,)):
        return dense_init(gen, i, o, device, dtype, lead)

    layers = {
        "attn": {"wq": dense(d, d), "bq": zeros(L, d), "wk": dense(d, d), "bk": zeros(L, d),
                 "wv": dense(d, d), "bv": zeros(L, d), "wo": dense(d, d), "bo": zeros(L, d)},
        "ln_attn": {"w": ones(L, d), "b": zeros(L, d)},
        "mlp": {"w1": dense(d, inner), "b1": zeros(L, inner),
                "w2": dense(inner, d), "b2": zeros(L, d)},
        "ln_mlp": {"w": ones(L, d), "b": zeros(L, d)},
    }
    if cfg.gated_rel_pos:
        layers["attn"]["grep_w"] = dense(cfg.head_dim, 8)
        layers["attn"]["grep_b"] = zeros(L, 8)
        layers["attn"]["grep_a"] = ones(L, cfg.n_heads)
    cg = d // cfg.conv_pos_groups
    params = {
        "patch_embed": {"w": dense(cfg.patch * cfg.patch, e, ()).view(cfg.patch, cfg.patch, 1, e),
                        "b": zeros(e)},
        "ln_patch": {"w": ones(e), "b": zeros(e)},
        "post_proj": {"w": dense(e, d, ()), "b": zeros(d)},
        "conv_pos": {"w": dense(cfg.conv_pos * cg, d, ()).view(cfg.conv_pos, cg, d),
                     "b": zeros(d)},
        "ln_pre": {"w": ones(d), "b": zeros(d)},
        "layers": layers,
    }
    if cfg.gated_rel_pos:
        params["rel_bias"] = normal_init(gen, (cfg.rel_pos_buckets, cfg.n_heads), 0.02,
                                         device, dtype)
    return params


def _conv_pos_embed(cfg: BeatsConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Grouped-conv positional embedding: w (K, C/G, C) as the JAX tree."""
    with full_f32():
        out = F.conv1d(x.transpose(1, 2), p["w"].to(x.dtype).permute(2, 1, 0),
                       p["b"].to(x.dtype), padding=cfg.conv_pos // 2,
                       groups=cfg.conv_pos_groups).transpose(1, 2)
    if cfg.conv_pos % 2 == 0:
        out = out[:, :-1]
    return gelu(out)


def _gate_scale_rows(cfg: BeatsConfig, a, x: torch.Tensor) -> torch.Tensor:
    """Per-query-row gate scale (B, H, T) f32 — the plain gate of the WavLM
    gru_rel_pos bias, from the raw layer input split into heads."""
    B, T, _ = x.shape
    xh = x.view(B, T, cfg.n_heads, cfg.head_dim).transpose(1, 2)
    return gate_rows(xh, a["grep_w"], a["grep_b"], a["grep_a"])


def _layer_forward(cfg: BeatsConfig, layer, x: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> torch.Tensor:
    B, T, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    a = layer["attn"]
    q = linear(x, a["wq"], a["bq"]).view(B, T, H, hd).transpose(1, 2)
    k = linear(x, a["wk"], a["bk"]).view(B, T, H, hd).transpose(1, 2)
    v = linear(x, a["wv"], a["bv"]).view(B, T, H, hd).transpose(1, 2)
    if bias is not None:
        xh = x.view(B, T, H, hd).transpose(1, 2)
        out = gated_bias_attention(q, k, v, xh, bias, a["grep_w"], a["grep_b"],
                                   a["grep_a"])
    else:
        out = flash_attention(q, k, v, None, causal=False)
    out = linear(out.transpose(1, 2).reshape(B, T, d), a["wo"], a["bo"])
    x = layer_norm(x * cfg.deep_norm_alpha + out, layer["ln_attn"]["w"], layer["ln_attn"]["b"])
    m = layer["mlp"]
    h = linear(gelu(linear(x, m["w1"], m["b1"])), m["w2"], m["b2"])
    return layer_norm(x * cfg.deep_norm_alpha + h, layer["ln_mlp"]["w"], layer["ln_mlp"]["b"])


def beats_num_tokens(cfg: BeatsConfig, n_samples: int) -> int:
    """Tokens a clip of ``n_samples`` produces; 30 s → 1496."""
    n_frames = (n_samples - 400) // 160 + 1
    return (n_frames // cfg.patch) * (cfg.n_fbank // cfg.patch)


def beats_bias_table(cfg: BeatsConfig, params: Dict[str, Any], n_tokens: int) -> torch.Tensor:
    """The shared gated-rel-pos bias table (H, T, T) f32 for a T-token clip —
    a function of the frozen rel_bias weights and T, built once per encode."""
    buckets = torch.from_numpy(relative_position_buckets(
        n_tokens, cfg.rel_pos_buckets, cfg.rel_pos_max_distance)).long()
    rel = params["rel_bias"]
    return rel.float()[buckets.to(rel.device)].permute(2, 0, 1).contiguous()


def beats_encode_fbank(cfg: BeatsConfig, params: Dict[str, Any], fbank: torch.Tensor,
                       dtype=torch.float32,
                       bias_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalized fbank (B, T_frames, n_fbank) → (B, n_tokens, dim)."""
    B, T, Fb = fbank.shape
    p = cfg.patch
    tp, fp = T // p, Fb // p
    x = fbank[:, : tp * p, : fp * p].reshape(B, tp, p, fp, p).permute(0, 1, 3, 2, 4)
    x = x.reshape(B, tp * fp, p * p).to(dtype)
    x = linear(x, params["patch_embed"]["w"].reshape(p * p, cfg.embed_dim),
               params["patch_embed"]["b"])
    x = layer_norm(x, params["ln_patch"]["w"], params["ln_patch"]["b"])
    x = linear(x, params["post_proj"]["w"], params["post_proj"]["b"])
    x = x + _conv_pos_embed(cfg, params["conv_pos"], x)
    x = layer_norm(x, params["ln_pre"]["w"], params["ln_pre"]["b"])
    bias = None
    if cfg.gated_rel_pos:
        bias = bias_table if bias_table is not None else beats_bias_table(cfg, params, x.shape[1])
        bias = bias.to(torch.bfloat16)  # the kernels read the table as bf16
    for l in range(cfg.n_layers):
        x = _layer_forward(cfg, layer_at(params["layers"], l), x, bias)
    return x


def beats_encode(cfg: BeatsConfig, params: Dict[str, Any], wav: torch.Tensor,
                 dtype=torch.float32, bias_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw wav (B, n) in [-1, 1] → (B, n_tokens, dim); 30 s → 1496 tokens."""
    fb = kaldi_fbank(wav * (2 ** 15), n_mels=cfg.n_fbank)
    fb = (fb - FBANK_MEAN) / (2 * FBANK_STD)
    return beats_encode_fbank(cfg, params, fb, dtype=dtype, bias_table=bias_table)
