"""Ring attention: context-parallel attention over a mesh axis.

Counterpart of ``icl_speech_text_llm_tpu/parallel/ring_attention.py``: the
KV sequence is cut into one shard a rank, and the shards rotate one hop
around the axis's group a step while each rank attends the shard in front
of it with online-softmax statistics, in f32, so the ranks together move
one all-gather's bytes, neighbour to neighbour.

Each rotation is one ``collectives.Shift`` of k and v packed into one
tensor (forward +1, backward the gradient −1), so the backward's transfers
are one chain of nodes the autograd engine runs in the same order on
every rank. The rotated heads are the un-repeated KV heads (the JAX
package rotates ``repeat_kv``'s copies; the result is the same with
n_rep times fewer bytes), and the last hop, which JAX makes only to
restore the placement, is not made. The math is plain PyTorch, as JAX's
is plain ``einsum`` (no Pallas kernel computes it).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from . import collectives as C
from .mesh import axis_group

NEG_INF = -1e30


def _ring_attention_local(q: torch.Tensor, k_shard: torch.Tensor, v_shard: torch.Tensor,
                          lengths: Optional[torch.Tensor], group, causal: bool,
                          sm_scale: float, q_offset: int = 0, layer: int = 0) -> torch.Tensor:
    """q (B, H, S_q, D) at global positions q_offset + i; this rank's KV
    shard k_shard/v_shard (B, Hkv, S_kv/n, D), shard j at positions
    [j · S_kv/n, (j + 1) · S_kv/n), Hkv dividing H (head h reads KV head
    h // (H / Hkv), as ``repeat_kv``); ``lengths`` (B,) the global valid
    KV length. Masked scores are −1e30 and a row whose denominator is 0
    gives 0, as the JAX package's. ``layer`` only tags the transfers."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    B, H, S_q, D = q.shape
    Hkv, shard_len = k_shard.shape[1], k_shard.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Hkv, g * S_q, D).float()
    q_pos = q_offset + torch.arange(S_q, device=q.device)
    m = torch.full((B, Hkv, g, S_q, 1), float("-inf"), device=q.device)
    l = torch.zeros((B, Hkv, g, S_q, 1), device=q.device)
    o = torch.zeros((B, Hkv, g, S_q, D), device=q.device)
    kv = torch.stack([k_shard.to(q.dtype), v_shard.to(q.dtype)])
    for step in range(n):
        src = (me - step) % n  # the rank this shard came from
        k_blk, v_blk = kv[0], kv[1]
        s = torch.matmul(qg, k_blk.float().transpose(-1, -2)).view(B, Hkv, g, S_q, shard_len)
        s = s * sm_scale
        kv_pos = src * shard_len + torch.arange(shard_len, device=q.device)
        mask = torch.ones((B, 1, 1, S_q, shard_len), dtype=torch.bool, device=q.device)
        if lengths is not None:
            mask = mask & (kv_pos < lengths.to(q.device)[:, None, None, None, None])
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_next)
        p = torch.exp(s - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.matmul(p.to(v_blk.dtype).view(B, Hkv, g * S_q, shard_len), v_blk)
        o = alpha * o + pv.float().view(B, Hkv, g, S_q, D)
        m = m_next
        if step < n - 1:
            kv = C.Shift.apply(kv, group, 1, C.tag(1, layer, step), C.tag(2, layer, step))
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (o / l_safe).reshape(B, H, S_q, D).to(q.dtype)


class _OwnShard(torch.autograd.Function):
    """This rank's 1/n block of ``x`` along ``dim`` forward. Backward: the
    ranks' block gradients gathered and divided by n, the gradient of a
    replicated input whose n replicated uses each sent their gradient of
    block j to rank j."""

    @staticmethod
    def forward(ctx, x, dim, group):
        n, me = dist.get_world_size(group), dist.get_rank(group)
        ctx.dim, ctx.group, ctx.n = dim, group, n
        size = x.shape[dim] // n
        return x.narrow(dim, me * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return C.all_gather(g, ctx.dim, ctx.group) / ctx.n, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis_name: str = "tp", lengths: Optional[torch.Tensor] = None,
                   causal: bool = True, sm_scale: Optional[float] = None,
                   layer: int = 0) -> torch.Tensor:
    """Context-parallel attention with the KV sequence cut over
    ``axis_name``: q (B, H, S_q, D) and k/v (B, Hkv, S_kv, D) are whole and
    the same on every rank of the axis (JAX's replicated q, and the k/v its
    ``shard_map`` cuts), each rank keeps its S_kv/n block of k/v, and the
    output is the same on every rank (up to the order each rank's online
    softmax visits the blocks). Under autograd each rank's replica sends
    its gradient of block j to rank j, which gathers the blocks back, so
    q, k and v get the replicated gradient on every rank. ``layer`` only
    tags the transfers."""
    group = axis_group(mesh, axis_name)
    n = dist.get_world_size(group)
    if k.shape[2] % n:
        raise ValueError(f"KV length {k.shape[2]} not divisible by {axis_name}={n}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    kv = _OwnShard.apply(torch.stack([k, v]), 3, group)
    return _ring_attention_local(q, kv[0], kv[1], lengths, group, causal, sm_scale, layer=layer)
