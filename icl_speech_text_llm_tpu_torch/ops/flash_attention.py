"""Attention kernels of the main path, each beside its plain PyTorch version.

Counterpart of ``icl_speech_text_llm_tpu/ops/flash_attention.py``. Six
Hopper kernels (``csrc/``) replace the Pallas kernels the port runs:

- ``flash_attention_causal``    — causal flash forward (LLM prefill, training);
- ``flash_attention_noncausal`` — non-causal flash forward (Whisper);
- ``gated_bias_attention``      — BEATs gated relative-position bias;
- ``append_kv``                 — in-place decode-step KV-cache append;
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

from typing import Optional, Tuple

import torch

from .. import kernels
from .attention import repeat_kv

_MAX_SCORE_ELEMS = 1 << 28  # plain versions: chunk the batch above 1 GiB of f32 scores


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


def append_kv_plain(cache_k, cache_v, new_k, new_v, positions):
    """Plain version of the append: cache (L, B, Hkv, S, D) gets new
    (L, B, Hkv, 1, D) at row positions[b], in place (``index_put_``)."""
    B = cache_k.shape[1]
    b_idx = torch.arange(B, device=cache_k.device)
    pos = positions.to(device=cache_k.device, dtype=torch.long)
    for cache, new in ((cache_k, new_k), (cache_v, new_v)):
        cache.permute(1, 3, 0, 2, 4).index_put_(
            (b_idx, pos), new[:, :, :, 0].permute(1, 0, 2, 3).to(cache.dtype))
    return cache_k, cache_v


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


def gated_bias_attention(q, k, v, xh, bias, grep_w, grep_b, grep_a,
                         lengths=None):
    """BEATs gated-bias attention → o like q. q/k/v/xh (B, H, S, D) (any
    strides with a contiguous last axis); bias (H, S, S); grep_w (D, 8);
    grep_b (8,); grep_a (H,); lengths (B,) or None."""
    if not _on_cuda(q):
        return gated_bias_attention_plain(q, k, v, xh, bias, grep_w, grep_b,
                                          grep_a, lengths)
    _refuse_detach("gated_bias_attention", q, k, v, xh, bias, grep_w, grep_b, grep_a)
    B, H, S, D = q.shape
    if D != 64:
        raise ValueError(f"gated-bias kernel takes head_dim 64, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v), ("xh", xh)):
        _check_attn_operand(name, t, q.device, D)
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q {tuple(q.shape)}")
    if bias.shape != (H, S, S):
        raise ValueError(f"bias must be ({H}, {S}, {S}), got {tuple(bias.shape)}")
    bias = bias.to(device=q.device, dtype=torch.bfloat16).contiguous()
    gw = grep_w.to(device=q.device, dtype=torch.float32).contiguous()
    gb = grep_b.to(device=q.device, dtype=torch.float32).contiguous()
    ga = grep_a.to(device=q.device, dtype=torch.float32).contiguous()
    if gw.shape != (D, 8) or gb.shape != (8,) or ga.shape != (H,):
        raise ValueError("grep_w/grep_b/grep_a must be (D, 8), (8,), (H,)")
    lens = _lengths_arg(lengths, B, q.device)
    o = torch.empty_like(q)
    strides = kernels.strides_arg(
        [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
         *xh.stride()[:3]])
    err = kernels.lib().iclk_gated_bias_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), xh.data_ptr(), bias.data_ptr(),
        gw.data_ptr(), gb.data_ptr(), ga.data_ptr(), o.data_ptr(),
        None if lens is None else lens.data_ptr(), B, H, S, D, strides,
        D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(err, "gated-bias attention")
    gated_bias_attention.launches += 1
    return o



def append_kv(cache_k, cache_v, new_k, new_v, positions) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one decode step's k/v for every layer into the stacked cache, in
    place: cache (L, B, Hkv, S, D), new (L, B, Hkv, 1, D), positions (B,).
    Returns the same cache tensors. The new rows are cast to the cache dtype
    (an int8 cache takes rows the caller has already quantized)."""
    if not _on_cuda(cache_k):
        return append_kv_plain(cache_k, cache_v, new_k, new_v, positions)
    L, B, Hkv, S, D = cache_k.shape
    if cache_v.shape != cache_k.shape or new_k.shape != (L, B, Hkv, 1, D) \
            or new_v.shape != new_k.shape:
        raise ValueError("append_kv: cache (L,B,Hkv,S,D) and new (L,B,Hkv,1,D) expected")
    if not (cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError("append_kv: the cache must be contiguous")
    if cache_v.dtype != cache_k.dtype:
        raise TypeError("append_kv: k and v caches differ in dtype")
    for t in (cache_v, new_k, new_v):
        if t.device != cache_k.device:
            raise ValueError(f"append_kv: tensor on {t.device}, cache on {cache_k.device}")
    nk = new_k.to(cache_k.dtype).contiguous()
    nv = new_v.to(cache_k.dtype).contiguous()
    pos = positions.to(device=cache_k.device, dtype=torch.int32).contiguous()
    err = kernels.lib().iclk_append_kv(
        cache_k.data_ptr(), cache_v.data_ptr(), nk.data_ptr(), nv.data_ptr(),
        pos.data_ptr(), L, B, Hkv, S, D, cache_k.element_size(),
        torch.cuda.current_stream(cache_k.device).cuda_stream)
    kernels.check(err, "append_kv")
    append_kv.launches += 1
    return cache_k, cache_v


kernels.register(flash_attention_causal, flash_attention_noncausal, gated_bias_attention,
                 append_kv, flash_attention_bwd_dq, flash_attention_bwd_dkv)
