"""Attention kernels of the main path, each beside its plain PyTorch version.

Counterpart of ``icl_speech_text_llm_tpu/ops/flash_attention.py``. Eleven
Hopper kernels (``csrc/``) replace the Pallas kernels of the JAX package:

- ``flash_attention_causal``    — causal flash forward (LLM prefill, training);
- ``flash_attention_noncausal`` — non-causal flash forward (Whisper);
- ``gated_bias_attention``      — BEATs gated relative-position bias (K3);
- ``gated_bias_attention_batched`` — K3's function with each bias tile
  staged once per chunk of two samples (K8;
  ``gated_bias_attention(batch_block=True)``);
- ``gated_bias_attention_rows`` — gated bias with the gate rows precomputed
  (K9; ``BeatsConfig.lean_bias_flash``);
- ``append_kv``                 — in-place decode-step KV-cache append (K4);
- ``append_kv_q8``              — the same into the int8 cache, the new rows
  quantized and their scales written in the same launch (K4 q8);
- ``flash_decode_attention``    — single-token decode attention over the
  bf16 cache with the current token folded in (K7);
- ``flash_decode_attention_q8`` — the same over the int8 cache, its scales
  folded into scores and probabilities (K7, int8 KV);
- ``flash_attention_bwd_dq``    — flash backward, dq and delta;
- ``flash_attention_bwd_dkv``   — flash backward, dk and dv.

Each wrapper dispatches on the device of its tensors: a CPU tensor takes the
plain version (``*_plain``), a CUDA tensor launches the kernel or raises. The
plain versions are the same math in f32 and are what the CPU tests and the
card's comparison run. Each wrapper counts its kernel launches in a plain
integer attribute, ``<wrapper>.launches``, registered in ``kernels.WRAPPERS``.

``flash_attention`` is the model code's op. When grad is enabled and an input
requires grad it goes through ``FlashAttention`` (forward K1/K2, backward
K5/K6; on the CPU the plain forward and the explicit plain backward); the
forward wrappers themselves refuse such inputs on the card rather than
return an output that autograd cannot trace.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from .. import kernels
from .attention import repeat_kv
from .int4_matmul import balanced
from .quant import quantize_kv

_MAX_SCORE_ELEMS = 1 << 28  # plain versions: chunk the batch above 1 GiB of f32 scores
LOG2E = 1.4426950408889634  # exp → exp2 fold of the gated-bias schedules
DECODE_MAX_REP = 8  # K7: query heads per kv head (the Pallas kernel's 8 sublanes)
DECODE_MAX_SPLITS = 8  # K7 q8: blocks of a cluster (the portable limit)


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {t.device}")


def _batch_chunks(B: int, per_sample: int):
    step = max(1, _MAX_SCORE_ELEMS // max(per_sample, 1))
    for s in range(0, B, step):
        yield slice(s, min(B, s + step))


def _key_valid(lengths: Optional[torch.Tensor], B: int, S_kv: int, device):
    cols = torch.arange(S_kv, device=device)
    if lengths is None:
        return torch.ones((B, 1, 1, S_kv), dtype=torch.bool, device=device)
    return (cols[None, :] < lengths.to(device)[:, None])[:, None, None, :]


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions compute in f32 (f64 for f64 inputs)."""
    return torch.promote_types(t.dtype, torch.float32)


def _softmax_pv(s: torch.Tensor, v: torch.Tensor):
    """f32 scores with -inf at masked keys → (o f32, m, l); a row without a
    valid key has l == 0 and o == 0 (the kernels' rule)."""
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul(p.to(v.dtype).to(s.dtype), v.to(s.dtype))
    inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    return o * inv[..., None], m, l


def flash_attention_plain(q, k, v, lengths=None, causal=True):
    """Plain version of the flash forward: q (B, H, S, D), k/v (B, Hkv, S_kv, D),
    lengths (B,) valid keys or None. Returns (o like q, m, l (B, H, S) f32);
    m is the e-domain row max of the masked scores, scaled by D^-1/2."""
    B, H, S, D = q.shape
    Hkv, S_kv = k.shape[1], k.shape[2]
    n_rep = H // Hkv
    ct = _acc_dtype(q)
    o = torch.empty_like(q)
    m = torch.empty((B, H, S), dtype=ct, device=q.device)
    l = torch.empty_like(m)
    valid_all = _key_valid(lengths, B, S_kv, q.device)
    if causal:
        rows = torch.arange(S, device=q.device)[:, None]
        valid_all = valid_all & (torch.arange(S_kv, device=q.device)[None, :] <= rows)
    for sl in _batch_chunks(B, H * S * S_kv):
        kk = repeat_kv(k[sl], n_rep).to(ct)
        vv = repeat_kv(v[sl], n_rep)
        s = torch.matmul(q[sl].to(ct), kk.transpose(-1, -2)) * D ** -0.5
        s = s.masked_fill(~valid_all[sl], float("-inf"))
        oc, mc, lc = _softmax_pv(s, vv)
        o[sl], m[sl], l[sl] = oc.to(q.dtype), mc, lc
    return o, m, l


def _row_delta(o, do):
    """delta = rowsum(do ∘ o) in f32, (B, H, S)."""
    ct = _acc_dtype(o)
    return (do.to(ct) * o.to(ct)).sum(-1)


def _bwd_plain(q, k, v, m, l, delta, do, lengths, causal, want_dq=True, want_dkv=True):
    """The flash backward from the saved (m, l) and delta, in f32: P is
    recomputed as exp(s − m) / l (0 at masked keys and on rows with l == 0),
    dS = P ∘ (dO·vᵀ − delta) · scale. Returns (dq, dk, dv) in the dtypes of
    q, k, v (None for a part not asked for); dk/dv of a kv head sum its
    H / Hkv query heads."""
    B, H, S, D = q.shape
    Hkv, S_kv = k.shape[1], k.shape[2]
    n_rep = H // Hkv
    scale = D ** -0.5
    ct = _acc_dtype(q)
    has_key = l > 0
    m_safe = torch.where(has_key, m, torch.zeros_like(m))[..., None]
    l_inv = torch.where(has_key, 1.0 / torch.where(has_key, l, torch.ones_like(l)),
                        torch.zeros_like(l))[..., None]
    valid_all = _key_valid(lengths, B, S_kv, q.device)
    if causal:
        rows = torch.arange(S, device=q.device)[:, None]
        valid_all = valid_all & (torch.arange(S_kv, device=q.device)[None, :] <= rows)
    dq = torch.empty((B, H, S, D), dtype=ct, device=q.device)
    dk = torch.empty((B, Hkv, S_kv, D), dtype=ct, device=q.device)
    dv = torch.empty_like(dk)
    for sl in _batch_chunks(B, H * S * S_kv):
        qf, dof = q[sl].to(ct), do[sl].to(ct)
        kk = repeat_kv(k[sl], n_rep).to(ct)
        vv = repeat_kv(v[sl], n_rep).to(ct)
        s = torch.matmul(qf, kk.transpose(-1, -2)) * scale
        s = s.masked_fill(~valid_all[sl], float("-inf"))
        p = torch.exp(s - m_safe[sl]) * l_inv[sl]
        dp = torch.matmul(dof, vv.transpose(-1, -2))
        ds = p * (dp - delta[sl].to(ct)[..., None]) * scale
        n = qf.shape[0]
        if want_dq:
            dq[sl] = torch.matmul(ds, kk)
        if want_dkv:
            dk[sl] = torch.matmul(ds.transpose(-1, -2), qf).view(n, Hkv, n_rep, S_kv, D).sum(2)
            dv[sl] = torch.matmul(p.transpose(-1, -2), dof).view(n, Hkv, n_rep, S_kv, D).sum(2)
    return (dq.to(q.dtype) if want_dq else None,
            dk.to(k.dtype) if want_dkv else None, dv.to(v.dtype) if want_dkv else None)


def flash_attention_bwd_plain(q, k, v, o, m, l, do, lengths=None, causal=True):
    """Plain version of the flash backward (K5 and K6 together): the saved
    forward tensors q, k, v, o, m, l and the upstream gradient do → (dq, dk,
    dv). Explicit math (no autograd through the plain forward), so the CPU
    tests check what the kernels compute."""
    return _bwd_plain(q, k, v, m, l, _row_delta(o, do), do, lengths, causal)


def flash_attention_bwd_dq_plain(q, k, v, o, m, l, do, lengths=None, causal=True):
    """Plain version of K5 alone → (dq, delta)."""
    delta = _row_delta(o, do)
    return _bwd_plain(q, k, v, m, l, delta, do, lengths, causal, want_dkv=False)[0], delta


def flash_attention_bwd_dkv_plain(q, k, v, m, l, delta, do, lengths=None, causal=True):
    """Plain version of K6 alone → (dk, dv)."""
    return _bwd_plain(q, k, v, m, l, delta, do, lengths, causal, want_dq=False)[1:]


def gate_rows(xh, grep_w, grep_b, grep_a):
    """Per-query-row gate (B, H, S) f32 of the gated relative-position bias:
    σ(Σproj[:4])·(σ(Σproj[4:])·grep_a[h] − 1) + 2, proj = xh·grep_w + grep_b."""
    proj = torch.matmul(xh.float(), grep_w.float()) + grep_b.float()
    ga = torch.sigmoid(proj[..., :4].sum(-1))
    gb = torch.sigmoid(proj[..., 4:].sum(-1))
    return ga * (gb * grep_a.float()[None, :, None] - 1.0) + 2.0


def gated_bias_attention_plain(q, k, v, xh, bias, grep_w, grep_b, grep_a,
                               lengths=None):
    """Plain version of the gated-bias kernel: q/k/v/xh (B, H, S, D), bias
    (H, S, S) rounded to bf16 as the kernel reads it, grep_w (D, 8), grep_b
    (8,), grep_a (H,). Returns o like q."""
    B, H, S, D = q.shape
    bias_f = bias.to(torch.bfloat16).float()
    valid = _key_valid(lengths, B, S, q.device)
    o = torch.empty_like(q)
    for sl in _batch_chunks(B, H * S * S):
        gate = gate_rows(xh[sl], grep_w, grep_b, grep_a)
        s = torch.matmul(q[sl].float(), k[sl].float().transpose(-1, -2)) * D ** -0.5
        s = s + gate[..., None] * bias_f[None]
        s = s.masked_fill(~valid[sl], float("-inf"))
        o[sl] = _softmax_pv(s, v[sl])[0].to(q.dtype)
    return o


def gated_bias_rows_plain(q, k, v, scale_rows, bias, lengths=None, pallas_rounding=True):
    """Plain version of K9 (and, with ``gate_rows`` for the gate, of K8), in
    the exp2 domain of the Pallas kernels: q pre-multiplied by
    D^-½·log2e in q's dtype, the gate rows (B, H, S) times log2e in f32, the
    bias (H, S, S) rounded to bf16, s − max rounded to v's dtype before the
    exp2 (so at bf16 the probabilities carry the kernels' bf16 rounding), the
    sum in f32 and P·V with P in v's dtype. Returns o like q.

    ``pallas_rounding=False`` scales q and takes the exp2 in f32 instead:
    the CUDA kernels' arithmetic, which the card's check holds them to."""
    B, H, S, D = q.shape
    c = D ** -0.5 * LOG2E
    qs = q * torch.tensor(c, dtype=q.dtype) if pallas_rounding else q.float() * c
    bias_f = bias.to(torch.bfloat16).float()
    gate2 = scale_rows.float() * LOG2E
    valid = _key_valid(lengths, B, S, q.device)
    o = torch.empty_like(q)
    for sl in _batch_chunks(B, H * S * S):
        s = torch.matmul(qs[sl].float(), k[sl].float().transpose(-1, -2))
        s = s + gate2[sl][..., None] * bias_f[None]
        s = s.masked_fill(~valid[sl], float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp2((s - m).to(v.dtype) if pallas_rounding else s - m).float()
        l = p.sum(dim=-1, keepdim=True)
        oc = torch.matmul(p.to(v.dtype).float(), v[sl].float())
        o[sl] = torch.where(l == 0, torch.zeros_like(oc), oc / l).to(q.dtype)
    return o


def gated_bias_batched_plain(q, k, v, xh, bias, grep_w, grep_b, grep_a, lengths=None,
                             pallas_rounding=True):
    """Plain version of K8: the gate of ``gate_rows`` into ``gated_bias_rows_plain``
    (the batched Pallas kernel's exp2-domain math)."""
    return gated_bias_rows_plain(q, k, v, gate_rows(xh, grep_w, grep_b, grep_a), bias, lengths,
                                 pallas_rounding)


def flash_decode_attention_plain(q, k, v, lengths, sm_scale=None, self_kv=None,
                                 k_s=None, v_s=None):
    """Plain version of K7, bf16 and int8 cache: q (B, H, 1, D); k/v (B, Hkv,
    S, D) of q's dtype, or int8 with per-position scales k_s/v_s (B, Hkv, S)
    f32; lengths (B,) cached positions to attend (PREVIOUS tokens when
    ``self_kv`` = (k_new, v_new), each (B, Hkv, 1, D), is given: the current
    token is one extra, always valid column, never quantized).

    The Pallas ``_decode_kernel``'s math: f32 scores q·k·sm_scale, k's scale
    on the score column, keys at or past the length masked, an e-domain
    softmax; v's scale multiplies p after p is summed into l; p is cast to
    q's dtype for the P·V product; the self column is the f32 Σq·k_new and
    p_self·v_new is added in f32; a row with l == 0 gives 0. GQA: query head
    h reads kv head h // (H / Hkv)."""
    B, H, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    scale = D ** -0.5 if sm_scale is None else sm_scale
    ct = _acc_dtype(q)
    qg = q.reshape(B, Hkv, H // Hkv, D).to(ct)
    s = torch.matmul(qg, k.to(q.dtype).to(ct).transpose(-1, -2)) * scale  # (B, Hkv, g, S)
    if k_s is not None:
        s = s * k_s.to(ct)[:, :, None, :]
    valid = torch.arange(S, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    if self_kv is not None:
        kn, vn = (t.reshape(B, Hkv, 1, D).to(q.dtype).to(ct) for t in self_kv)
        s_self = (qg * kn).sum(-1, keepdim=True) * scale  # (B, Hkv, g, 1)
        m = torch.maximum(m, s_self)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if v_s is not None:
        p = p * v_s.to(ct)[:, :, None, :]
    o = torch.matmul(p.to(q.dtype).to(ct), v.to(q.dtype).to(ct))
    if self_kv is not None:
        p_self = torch.exp(s_self - m)
        l = l + p_self
        o = o + p_self * vn
    o = torch.where(l == 0, torch.zeros_like(o), o / torch.where(l == 0, torch.ones_like(l), l))
    return o.reshape(B, H, 1, D).to(q.dtype)


def _put_rows(cache, rows, positions):
    """cache (L, B, Hkv, S, …) gets rows (L, B, Hkv, …) at position
    positions[b] of sample b, in place (``index_put_``). A position outside
    [0, S) leaves its sample's rows as they are, as the kernels do: they are
    written back with their own values, so no host sync is needed."""
    S = cache.shape[3]
    view = cache.permute(1, 3, 0, 2, *range(4, cache.dim()))
    pos = positions.to(device=cache.device, dtype=torch.long)
    keep = ((pos >= 0) & (pos < S)).view(-1, *[1] * (rows.dim() - 1))
    idx = (torch.arange(cache.shape[1], device=cache.device), pos.clamp(0, S - 1))
    view.index_put_(idx, torch.where(keep, rows.transpose(0, 1).to(cache.dtype), view[idx]))


def append_kv_plain(cache_k, cache_v, new_k, new_v, positions):
    """Plain version of the append: cache (L, B, Hkv, S, D) gets new
    (L, B, Hkv, 1, D) at row positions[b], in place; positions outside
    [0, S) are not written."""
    _put_rows(cache_k, new_k[:, :, :, 0], positions)
    _put_rows(cache_v, new_v[:, :, :, 0], positions)
    return cache_k, cache_v


def append_kv_q8_plain(cache_k, cache_v, scale_k, scale_v, new_k, new_v, positions):
    """Plain version of the quantizing append: the new rows (L, B, Hkv, 1, D)
    quantized by ``quantize_kv``, then the int8 rows into the (L, B, Hkv, S,
    D) cache and their scales into the f32 (L, B, Hkv, S) planes at
    positions[b], in place, as the JAX package's decode step quantizes
    in its scan and writes rows and scales by a per-sample
    dynamic_update_slice."""
    for cache, plane, new in ((cache_k, scale_k, new_k), (cache_v, scale_v, new_v)):
        q, s = quantize_kv(new[:, :, :, 0])
        _put_rows(cache, q, positions)
        _put_rows(plane, s, positions)
    return cache_k, cache_v, scale_k, scale_v


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_attn_operand(name, t, device, D=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16 for the CUDA kernel, got {t.dtype}")
    if t.dim() != 4 or t.stride(-1) != 1:
        raise ValueError(f"{name} must be 4-D with a contiguous last axis")
    if D is not None and t.shape[-1] != D:
        raise ValueError(f"{name} head_dim {t.shape[-1]} != {D}")
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"{name} rows must be 16-byte aligned (strides {t.stride()})")


def _lengths_arg(lengths, B, device):
    if lengths is None:
        return None
    if lengths.shape != (B,):
        raise ValueError(f"lengths must have shape ({B},), got {tuple(lengths.shape)}")
    return lengths.to(device=device, dtype=torch.int32).contiguous()


def _flash_cuda(q, k, v, lengths, causal):
    B, H, S, D = q.shape
    Hkv, S_kv = k.shape[1], k.shape[2]
    if D not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {D}")
    if H % Hkv or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if causal and S != S_kv:
        raise ValueError("causal flash attention needs S == S_kv")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_attn_operand(name, t, q.device)
    lens = _lengths_arg(lengths, B, q.device)
    o = torch.empty_like(q)
    m = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    strides = kernels.strides_arg(
        [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], 0, 0, 0])
    err = kernels.lib().iclk_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
        l.data_ptr(), None if lens is None else lens.data_ptr(),
        B, H, Hkv, S, S_kv, D, int(causal), strides, D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "flash attention")
    return o, m, l


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _refuse_detach(name, *tensors):
    """A kernel filled through ctypes returns a tensor autograd cannot trace:
    refuse inputs that need a gradient instead of dropping it silently."""
    if _wants_grad(*tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but this kernel call is not "
            "differentiable; call flash_attention (FlashAttention) for a "
            "differentiable op, or run under torch.no_grad()")


def flash_attention_causal(q, k, v, lengths=None):
    """Causal flash forward → (o, m, l). q (B, H, S, D); k/v (B, Hkv, S, D)
    with H % Hkv == 0 (GQA reads kv head h // (H / Hkv)); lengths (B,)."""
    if not _on_cuda(q):
        return flash_attention_plain(q, k, v, lengths, True)
    _refuse_detach("flash_attention_causal", q, k, v)
    out = _flash_cuda(q, k, v, lengths, True)
    flash_attention_causal.launches += 1
    return out


def flash_attention_noncausal(q, k, v, lengths=None):
    """Non-causal flash forward with a per-sample key length → (o, m, l)."""
    if not _on_cuda(q):
        return flash_attention_plain(q, k, v, lengths, False)
    _refuse_detach("flash_attention_noncausal", q, k, v)
    out = _flash_cuda(q, k, v, lengths, False)
    flash_attention_noncausal.launches += 1
    return out


def _bwd_check(q, k, v, do, lengths, causal):
    B, H, S, D = q.shape
    Hkv, S_kv = k.shape[1], k.shape[2]
    if D not in (64, 128):
        raise ValueError(f"flash backward kernels take head_dim 64 or 128, got {D}")
    if H % Hkv or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or do.shape != q.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do {tuple(do.shape)}")
    if causal and S != S_kv:
        raise ValueError("causal flash attention needs S == S_kv")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_attn_operand(name, t, q.device)
    return _lengths_arg(lengths, B, q.device)


def _stat_arg(name, t, q):
    shape = q.shape[:3]
    if t.shape != shape or t.dtype != torch.float32 or t.device != q.device:
        raise ValueError(f"{name} must be f32 {tuple(shape)} on {q.device}")
    return t.contiguous()


def _bwd_strides(q, k, v, o, do, dq, dk, dv):
    return kernels.strides_arg([s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]])


def flash_attention_bwd_dq(q, k, v, o, m, l, do, lengths=None, causal=True):
    """Flash backward, K5: dq and delta = rowsum(do ∘ o) → (dq like q,
    delta (B, H, S) f32). Inputs as ``flash_attention_bwd_plain``; delta
    feeds ``flash_attention_bwd_dkv``."""
    if not _on_cuda(q):
        return flash_attention_bwd_dq_plain(q, k, v, o, m, l, do, lengths, causal)
    lens = _bwd_check(q, k, v, do, lengths, causal)
    _check_attn_operand("o", o, q.device, q.shape[-1])
    m, l = _stat_arg("m", m, q), _stat_arg("l", l, q)
    B, H, S, D = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty_like(m)
    err = kernels.lib().iclk_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        None if lens is None else lens.data_ptr(), B, H, k.shape[1], S, k.shape[2], D,
        int(causal), _bwd_strides(q, k, v, o, do, dq, k, v), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "flash backward dq")
    flash_attention_bwd_dq.launches += 1
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, m, l, delta, do, lengths=None, causal=True):
    """Flash backward, K6: (dk, dv) like k and v, (B, Hkv, S_kv, D), each
    the sum over the H / Hkv query heads of its group."""
    if not _on_cuda(q):
        return flash_attention_bwd_dkv_plain(q, k, v, m, l, delta, do, lengths, causal)
    lens = _bwd_check(q, k, v, do, lengths, causal)
    m, l, delta = _stat_arg("m", m, q), _stat_arg("l", l, q), _stat_arg("delta", delta, q)
    B, H, S, D = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = kernels.lib().iclk_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(),
        l.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if lens is None else lens.data_ptr(), B, H, k.shape[1], S, k.shape[2], D,
        int(causal), _bwd_strides(q, k, v, q, do, q, dk, dv), D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "flash backward dk/dv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: forward K1 (causal) or K2, backward K5
    then K6 on the card; on the CPU the plain forward and the explicit plain
    backward. ``apply(q, k, v, lengths, causal)`` → o like q."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal):
        fwd = flash_attention_causal if causal else flash_attention_noncausal
        o, m, l = fwd(q, k, v, lengths)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, m, l, lengths)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, m, l, lengths = ctx.saved_tensors
        if not _on_cuda(q):
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, m, l, do, lengths, ctx.causal)
            return dq, dk, dv, None, None
        if do.stride(-1) != 1 or do.data_ptr() % 16 or any(s % 8 for s in do.stride()[:3]):
            do = do.contiguous()
        dq, delta = flash_attention_bwd_dq(q, k, v, o, m, l, do, lengths, ctx.causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, m, l, delta, do, lengths, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, lengths=None, causal=True):
    """The model code's attention op: returns o (B, H, S, D) like q, through
    ``FlashAttention`` when autograd needs it."""
    if _wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, lengths, causal)
    fn = flash_attention_causal if causal else flash_attention_noncausal
    return fn(q, k, v, lengths)[0]


def _gated_bias_check(name, q, tensors, bias):
    """Operand checks shared by the gated-bias kernels (K3, K8, K9) → the
    bias as contiguous bf16 on q's device."""
    _refuse_detach(name, *tensors, bias)
    B, H, S, D = q.shape
    if D != 64:
        raise ValueError(f"{name}: the kernel takes head_dim 64, got {D}")
    for i, t in enumerate(tensors):
        _check_attn_operand(f"{name} operand {i}", t, q.device, D)
        if t.shape != q.shape:
            raise ValueError(f"{name}: operand shape {tuple(t.shape)} != q {tuple(q.shape)}")
    if bias.shape != (H, S, S):
        raise ValueError(f"{name}: bias must be ({H}, {S}, {S}), got {tuple(bias.shape)}")
    return bias.to(device=q.device, dtype=torch.bfloat16).contiguous()


def _grep_args(q, grep_w, grep_b, grep_a):
    D, H = q.shape[3], q.shape[1]
    gw, gb, ga = (t.to(device=q.device, dtype=torch.float32).contiguous()
                  for t in (grep_w, grep_b, grep_a))
    if gw.shape != (D, 8) or gb.shape != (8,) or ga.shape != (H,):
        raise ValueError("grep_w/grep_b/grep_a must be (D, 8), (8,), (H,)")
    return gw, gb, ga


def tma_bias_rows(bias: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The (H, S, S) bias table as K3/K8/K9's TMA reads it → (table, row stride
    in elements): the table itself when S is a multiple of 8 (BEATs' token
    counts are: 16-byte rows), else a copy whose rows are padded with zeros
    to the next multiple of 8 keys (the kernel reads only the first S)."""
    S = bias.shape[-1]
    pad = -S % 8
    if not pad:
        return bias, S
    padded = torch.zeros((*bias.shape[:-1], S + pad), dtype=bias.dtype, device=bias.device)
    padded[..., :S] = bias
    return padded, S + pad


def _gated_bias_launch(entry, q, k, v, xh, bias, gw, gb, ga, lengths, B, H, S, D):
    lens = _lengths_arg(lengths, B, q.device)
    o = torch.empty_like(q)
    bias, bias_row = tma_bias_rows(bias)
    strides = kernels.strides_arg(
        [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
         *xh.stride()[:3], bias_row])
    err = getattr(kernels.lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), xh.data_ptr(), bias.data_ptr(),
        gw.data_ptr(), gb.data_ptr(), ga.data_ptr(), o.data_ptr(),
        None if lens is None else lens.data_ptr(), B, H, S, D, strides,
        D ** -0.5, torch._C._cuda_getCurrentRawStream(q.device.index))
    kernels.check(err, entry)
    return o


def gated_bias_attention(q, k, v, xh, bias, grep_w, grep_b, grep_a,
                         lengths=None, batch_block=False):
    """BEATs gated-bias attention → o like q. q/k/v/xh (B, H, S, D) (any
    strides with a contiguous last axis); bias (H, S, S); grep_w (D, 8);
    grep_b (8,); grep_a (H,); lengths (B,) or None. ``batch_block`` takes
    the batched schedule, ``gated_bias_attention_batched`` (K8), as the JAX
    package's opt-in argument of the same name does."""
    if batch_block:
        return gated_bias_attention_batched(q, k, v, xh, bias, grep_w, grep_b, grep_a,
                                            lengths)
    if not _on_cuda(q):
        return gated_bias_attention_plain(q, k, v, xh, bias, grep_w, grep_b,
                                          grep_a, lengths)
    bias = _gated_bias_check("gated_bias_attention", q, (q, k, v, xh), bias)
    o = _gated_bias_launch("iclk_gated_bias_fwd", q, k, v, xh, bias,
                           *_grep_args(q, grep_w, grep_b, grep_a), lengths, *q.shape)
    gated_bias_attention.launches += 1
    return o


def gated_bias_attention_batched(q, k, v, xh, bias, grep_w, grep_b, grep_a, lengths=None):
    """K8: K3's inputs and function, a work item per (head, q-block, chunk
    of two samples): each key tile's bias tile lands in shared memory once
    and serves both samples. Exp2-domain math (``gated_bias_batched_plain``)."""
    if not _on_cuda(q):
        return gated_bias_batched_plain(q, k, v, xh, bias, grep_w, grep_b, grep_a, lengths)
    bias = _gated_bias_check("gated_bias_attention_batched", q, (q, k, v, xh), bias)
    o = _gated_bias_launch("iclk_gated_bias_batched", q, k, v, xh, bias,
                           *_grep_args(q, grep_w, grep_b, grep_a), lengths, *q.shape)
    gated_bias_attention_batched.launches += 1
    return o


def flash_bias_rows_usable(B: int, H: int, S: int, D: int) -> bool:
    """Shape gate of K9 (``gated_bias_attention_rows``): head_dim 64, any
    sequence length (the kernel masks the ragged last tile)."""
    return D == 64 and min(B, H, S) > 0


def gated_bias_attention_rows(q, k, v, scale_rows, bias, lengths=None):
    """K9: gated-bias attention with the gate precomputed, ``scale_rows``
    (B, H, S) f32 (``gate_rows``, not log2e-scaled); q/k/v (B, H, S, D);
    bias (H, S, S); lengths (B,) or None → o like q. K3's kernel with the
    gate read from the rows: the work items of one (head, query block) run
    for every sample back to back, so the bias rows they share are read from
    device memory about once."""
    if not _on_cuda(q):
        return gated_bias_rows_plain(q, k, v, scale_rows, bias, lengths)
    bias = _gated_bias_check("gated_bias_attention_rows", q, (q, k, v), bias)
    B, H, S, D = q.shape
    rows = scale_rows.to(device=q.device, dtype=torch.float32).contiguous()
    if rows.shape != (B, H, S):
        raise ValueError(f"scale_rows must be ({B}, {H}, {S}), got {tuple(rows.shape)}")
    lens = _lengths_arg(lengths, B, q.device)
    o = torch.empty_like(q)
    bias, bias_row = tma_bias_rows(bias)
    strides = kernels.strides_arg(
        [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], bias_row])
    err = kernels.lib().iclk_gated_bias_rows(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rows.data_ptr(), bias.data_ptr(),
        o.data_ptr(), None if lens is None else lens.data_ptr(), B, H, S, D, strides,
        D ** -0.5, torch._C._cuda_getCurrentRawStream(q.device.index))
    kernels.check(err, "iclk_gated_bias_rows")
    gated_bias_attention_rows.launches += 1
    return o


def _append_check(name, caches, news, positions, cache_dtype):
    """The append wrappers' checks → (L, B, Hkv, S, D). They refuse, and
    never copy, what the kernel does not take as it comes: each cache (L,
    B, Hkv, S, D) of ``cache_dtype`` and each new row set (L, B, Hkv, 1, D)
    of one dtype, contiguous, on the cache's device; positions (B,) int32
    there."""
    L, B, Hkv, S, D = caches[0].shape
    dev = caches[0].device
    for t in caches:
        if t.shape != (L, B, Hkv, S, D) or t.dtype != cache_dtype:
            raise ValueError(f"{name}: caches must be {cache_dtype} (L, B, Hkv, S, D), got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in news:
        if t.shape != (L, B, Hkv, 1, D) or t.dtype != news[0].dtype:
            raise ValueError(f"{name}: new rows must be (L, B, Hkv, 1, D) = "
                             f"{(L, B, Hkv, 1, D)} of one dtype, got {t.dtype} {tuple(t.shape)}")
    if positions.shape != (B,) or positions.dtype != torch.int32:
        raise ValueError(f"{name}: positions must be int32 ({B},), got {positions.dtype} "
                         f"{tuple(positions.shape)}")
    for t in (*caches, *news, positions):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous on {dev}")
    return L, B, Hkv, S, D


def append_kv(cache_k, cache_v, new_k, new_v, positions) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: write one decode step's k/v for every layer into the stacked cache,
    in place: cache (L, B, Hkv, S, D), new (L, B, Hkv, 1, D) of the cache's
    dtype (an int8 cache takes rows the caller quantized; ``append_kv_q8``
    quantizes them itself), positions (B,) int32; positions outside [0, S)
    are not written. On the card a row is a multiple of 16 bytes (bf16 at
    D % 8 == 0, int8 at D % 16 == 0). Returns the same cache tensors."""
    if not _on_cuda(cache_k):
        return append_kv_plain(cache_k, cache_v, new_k, new_v, positions)
    L, B, Hkv, S, D = _append_check("append_kv", (cache_k, cache_v), (new_k, new_v),
                                    positions, cache_k.dtype)
    if new_k.dtype != cache_k.dtype:
        raise TypeError(f"append_kv: new rows {new_k.dtype} into a {cache_k.dtype} cache")
    if D * cache_k.element_size() % 16 or any(
            t.data_ptr() % 16 for t in (cache_k, cache_v, new_k, new_v)):
        raise ValueError(f"append_kv: rows of {D * cache_k.element_size()} bytes, or their "
                         "tensors, are not 16-byte aligned")
    index = cache_k.device.index
    err = kernels.lib().iclk_append_kv(
        cache_k.data_ptr(), cache_v.data_ptr(), new_k.data_ptr(), new_v.data_ptr(),
        positions.data_ptr(), L, B, Hkv, S, D, cache_k.element_size(), kernels.sm_count(index),
        torch._C._cuda_getCurrentRawStream(index))
    kernels.check(err, "append_kv")
    append_kv.launches += 1
    return cache_k, cache_v


def append_kv_q8(cache_k, cache_v, scale_k, scale_v, new_k, new_v, positions):
    """K4 q8: quantize one decode step's k/v rows of every layer and write
    them into the stacked int8 cache with their scales, in one launch, in
    place: cache (L, B, Hkv, S, D) int8, scales (L, B, Hkv, S) f32, new
    (L, B, Hkv, 1, D) bf16 or f32 (the activations as they come), positions
    (B,) int32; positions outside [0, S) are not written. On the card D is
    a multiple of 8, at most 256. Math: ``append_kv_q8_plain``, bit for bit.
    Returns the four cache tensors."""
    if not _on_cuda(cache_k):
        return append_kv_q8_plain(cache_k, cache_v, scale_k, scale_v, new_k, new_v, positions)
    L, B, Hkv, S, D = _append_check("append_kv_q8", (cache_k, cache_v), (new_k, new_v),
                                    positions, torch.int8)
    for t in (scale_k, scale_v):
        if t.shape != (L, B, Hkv, S) or t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != cache_k.device:
            raise ValueError(f"append_kv_q8: scales must be contiguous f32 {(L, B, Hkv, S)} "
                             f"on {cache_k.device}")
    if new_k.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"append_kv_q8: new rows must be bfloat16 or float32, got {new_k.dtype}")
    if D % 8 or D > 256:
        raise ValueError(f"append_kv_q8: head_dim {D} must be a multiple of 8, at most 256")
    if new_k.data_ptr() % 16 or new_v.data_ptr() % 16:
        raise ValueError("append_kv_q8: new rows must be 16-byte aligned")
    index = cache_k.device.index
    err = kernels.lib().iclk_append_kv_q8(
        cache_k.data_ptr(), cache_v.data_ptr(), scale_k.data_ptr(), scale_v.data_ptr(),
        new_k.data_ptr(), new_v.data_ptr(), positions.data_ptr(), L, B, Hkv, S, D,
        int(new_k.dtype == torch.float32), kernels.sm_count(index),
        torch._C._cuda_getCurrentRawStream(index))
    kernels.check(err, "append_kv_q8")
    append_kv_q8.launches += 1
    return cache_k, cache_v, scale_k, scale_v


def flash_decode_usable(q_shape, kv_shape) -> bool:
    """Shape gate of K7: one query position, head_dim 128, H a multiple of
    Hkv with at most ``DECODE_MAX_REP`` query heads per kv head. Shapes are
    (B, H, 1, D) and (B, Hkv, S, D)."""
    if len(q_shape) != 4 or len(kv_shape) != 4:
        return False
    B, H, Tq, D = q_shape
    Bk, Hkv, S, Dk = kv_shape
    return (Tq == 1 and D == 128 and Dk == D and Bk == B and S > 0 and Hkv > 0
            and H % Hkv == 0 and H // Hkv <= DECODE_MAX_REP)


def decode_sm_blocks(blocks: int, sms: int) -> list:
    """Model of the card's block scheduler for K7 q8 → the blocks each of
    ``sms`` SMs streams: every block of a grid carries the same share of
    rows (samples of about one length), so each goes to the SM with the
    fewest so far, which deals them out in turn."""
    return [blocks // sms + (i < blocks % sms) for i in range(sms)]


def decode_splits(B: int, Hkv: int, sms: int, resident) -> int:
    """Cluster size c of K7 q8 (blocks per (sample, kv head)), from the grid
    and ``resident``, the blocks the card holds at once for each c
    (``resident[c − 1]``, from the kernel's occupancy): the largest c whose
    grid the card holds in one wave and whose busiest SM streams at most
    1.1× the mean (``decode_sm_blocks``); failing that the smallest c that is
    balanced; failing both, the c whose busiest SM has the least share.

    Why (the sweeps of ``chip_smoke._decode_sweep`` on an H100): a grid
    larger than one wave runs its blocks in lockstep waves whose loads and
    math do not overlap (at B = 4, Hkv = 40, c = 4 is 640 blocks for 616
    slots and runs 1.3× slower than c = 3); within one wave more blocks
    hide more latency, and an SM with more than 1.1× the mean holds the
    call back. At the 13B decode (B = 4, Hkv = 40: 160 pairs for 132 SMs)
    that is c = 3; pairs that fill the card already (B = 16, Hkv = 40) take
    c = 1 and no merge."""
    shares, even = {}, []
    for c in range(1, DECODE_MAX_SPLITS + 1):
        work = decode_sm_blocks(B * Hkv * c, sms)
        shares[c] = max(work) * sms / sum(work)
        if balanced(work):
            even.append(c)
    fits = [c for c in even if B * Hkv * c <= resident[c - 1]]
    if fits:
        return max(fits)
    return min(even) if even else min(shares, key=shares.get)


@functools.lru_cache(maxsize=None)
def decode_resident(index: int, n_rep: int) -> tuple:
    """Blocks of K7 q8 (n_rep query heads a kv head) that device ``index``
    holds at once, for each cluster size 1 to ``DECODE_MAX_SPLITS``."""
    with torch.cuda.device(index):
        lib = kernels.lib()
        return tuple(c * lib.iclk_flash_decode_q8_max_clusters(n_rep, c)
                     for c in range(1, DECODE_MAX_SPLITS + 1))


def _q8_layout_ok(k, v, k_s, v_s) -> bool:
    """The int8 cache as K7 q8's copies read it (TMA boxes of rows, bulk
    copies of scales): each (sample, head)'s rows one contiguous run (row
    stride D, head_dim contiguous) and its scales too (stride 1), every run
    16-byte aligned, S a multiple of 4."""
    S = k.shape[2]
    return (S % 4 == 0 and all(t.stride(2) == t.shape[3] and t.stride(3) == 1
                               and t.stride(0) % 16 == 0 and t.stride(1) % 16 == 0
                               for t in (k, v))
            and all(t.stride(2) == 1 and t.stride(0) % 4 == 0 and t.stride(1) % 4 == 0
                    for t in (k_s, v_s))
            and not any(t.data_ptr() % 16 for t in (k, v, k_s, v_s)))


def q8_cache_layout_ok(k, v, k_s, v_s) -> bool:
    """``_q8_layout_ok`` for every layer of the stacked int8 cache (L, B,
    Hkv, S, D) and its scales (L, B, Hkv, S): layer 0's views pass it, and
    each layer starts a 16-byte multiple after the one before."""
    return (_q8_layout_ok(k[0], v[0], k_s[0], v_s[0])
            and all(t.stride(0) * t.element_size() % 16 == 0 for t in (k, v, k_s, v_s)))


def _decode_launch(name, q, k, v, k_s, v_s, lengths, sm_scale, self_kv):
    """Checks and one launch of ``iclk_flash_decode`` (k_s/v_s None for the
    bf16 cache; the int8 cache split over ``decode_splits`` blocks a
    cluster) → o (B, H, 1, D)."""
    B, H, _, D = q.shape
    if not flash_decode_usable(q.shape, k.shape) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} are not ones the kernel takes")
    quant = k_s is not None
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{name}: q must be bfloat16 for the CUDA kernel, got {q.dtype}")
    want = torch.int8 if quant else torch.bfloat16
    if k.dtype != want or v.dtype != want:
        raise TypeError(f"{name}: the cache must be {want}, got {k.dtype}/{v.dtype}")
    for t in (k, v) + ((k_s, v_s) if quant else ()):
        if t.device != q.device:
            raise ValueError(f"{name}: tensor on {t.device}, q on {q.device}")
        if t.stride(-1) != 1 or t.data_ptr() % 16 or (t.dim() == 4 and any(
                (s * t.element_size()) % 16 for s in t.stride()[:3])):
            raise ValueError(f"{name}: cache rows must be contiguous and 16-byte aligned")
    if quant and (k_s.shape != k.shape[:3] or v_s.shape != k.shape[:3]
                  or k_s.dtype != torch.float32 or v_s.dtype != torch.float32):
        raise ValueError(f"{name}: scales must be f32 {tuple(k.shape[:3])}")
    if quant and not _q8_layout_ok(k, v, k_s, v_s):
        raise ValueError(f"{name}: the int8 cache's rows and scales must be contiguous along "
                         f"S, 16-byte aligned, S a multiple of 4 (strides {k.stride()}, "
                         f"{k_s.stride()})")
    if lengths is None:
        raise ValueError(f"{name}: lengths (B,) are required")
    qc = q.contiguous()
    lens = _lengths_arg(lengths, B, q.device)
    Hkv, S = k.shape[1], k.shape[2]
    kn = vn = None
    if self_kv is not None:
        kn, vn = (t.to(q.dtype).reshape(B, Hkv, D).contiguous() for t in self_kv)
    o = torch.empty((B, H, 1, D), dtype=q.dtype, device=q.device)
    index = q.device.index
    splits = decode_splits(B, Hkv, kernels.sm_count(index),
                           decode_resident(index, H // Hkv)) if quant else 1
    strides = kernels.strides_arg(
        [*k.stride()[:3], *v.stride()[:3],
         *(k_s.stride() if quant else (0, 0, 0)), *(v_s.stride() if quant else (0, 0, 0))])
    err = kernels.lib().iclk_flash_decode(
        qc.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_s.data_ptr() if quant else None, v_s.data_ptr() if quant else None,
        None if kn is None else kn.data_ptr(), None if vn is None else vn.data_ptr(),
        o.data_ptr(), lens.data_ptr(), B, H, Hkv, S, D, splits, strides,
        D ** -0.5 if sm_scale is None else sm_scale,
        torch._C._cuda_getCurrentRawStream(q.device.index))
    kernels.check(err, name)
    return o


def flash_decode_attention(q, k, v, lengths, sm_scale=None, self_kv=None, layer=None):
    """K7 over a bf16 cache: q (B, H, 1, D); k/v (B, Hkv, S, D), or the
    stacked (L, B, Hkv, S, D) cache with ``layer`` an int, read in place
    (``k[layer]`` is a view); lengths (B,) positions to attend, PREVIOUS
    tokens when ``self_kv`` = (k_new, v_new) (B, Hkv, 1, D) is given → o
    (B, H, 1, D) like q. Math: ``flash_decode_attention_plain``."""
    if layer is not None:
        k, v = k[layer], v[layer]
    if not _on_cuda(q):
        return flash_decode_attention_plain(q, k, v, lengths, sm_scale, self_kv)
    o = _decode_launch("flash_decode_attention", q, k, v, None, None, lengths, sm_scale,
                       self_kv)
    flash_decode_attention.launches += 1
    return o


def flash_decode_attention_q8(q, k8, v8, k_s, v_s, lengths, sm_scale=None, self_kv=None,
                              layer=None):
    """K7 over an int8 cache: k8/v8 (B, Hkv, S, D) int8 with per-position
    f32 scales k_s/v_s (B, Hkv, S), or their stacked (L, ...) forms with
    ``layer``; the current token's ``self_kv`` stays unquantized. On the
    card each (sample, head)'s rows and scales must be contiguous along S
    (as ``init_kv_cache`` lays them out), S a multiple of 4. Otherwise as
    ``flash_decode_attention``."""
    if layer is not None:
        k8, v8, k_s, v_s = k8[layer], v8[layer], k_s[layer], v_s[layer]
    if not _on_cuda(q):
        return flash_decode_attention_plain(q, k8, v8, lengths, sm_scale, self_kv, k_s, v_s)
    o = _decode_launch("flash_decode_attention_q8", q, k8, v8, k_s, v_s, lengths, sm_scale,
                       self_kv)
    flash_decode_attention_q8.launches += 1
    return o


kernels.register(flash_attention_causal, flash_attention_noncausal, gated_bias_attention,
                 gated_bias_attention_batched, gated_bias_attention_rows, append_kv,
                 append_kv_q8, flash_decode_attention, flash_decode_attention_q8,
                 flash_attention_bwd_dq, flash_attention_bwd_dkv)
