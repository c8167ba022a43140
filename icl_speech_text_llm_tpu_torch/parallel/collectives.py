"""Explicit collectives of the sharded model, autograd-aware.

GSPMD inserts the JAX package's collectives itself; the port has no such
compiler, so the layer code calls these at the points where Megatron-style
tensor parallelism and FSDP put them (``parallel/sharding.py`` holds the
shard context that names the groups):

- ``CopyToGroup``: identity forward, all-reduce backward (the input of a
  column-parallel block, and a tp-replicated trainable leaf that multiplies
  a tp-sharded operand);
- ``ReduceFromGroup``: all-reduce forward (in f32, cast once), identity
  backward (the output of a row-parallel block, a masked vocab lookup, the
  vocab-parallel softmax sums);
- ``GatherShards``: all-gather forward, reduce-scatter backward (an
  FSDP-sharded trainable leaf, gathered at its layer's start; the
  split-head path's q/k/v column blocks, gathered into whole heads);
- ``GatherDim``: all-gather forward, this rank's slice backward (logits
  and heads gathered along a dim);
- ``send`` / ``recv``: one tensor from this rank to a neighbour of its
  group (the pipeline's activations and their gradients), and ``Shift``:
  every rank of a group sends to the rank ``offset`` after it and receives
  from the one ``offset`` before it, forward; the reverse shift of the
  gradient backward (ring attention's KV rotation).

Every call to a primitive counts one under its family (``counts()``; each
send and each receive one ``p2p``), so tests and ``chip_smoke.py`` hold
the number a step makes to a formula. Every transfer carries a tag that
names what it moves (``tag``): under gloo a receive only matches the send
of its own tag, so a pair posted out of order waits out the group's
timeout and raises rather than taking another tensor (NCCL matches by
order alone).

Transport: the group's backend decides it, never a failure. Under NCCL the
tensors go as they are; under gloo a CUDA tensor is staged through pinned
host memory on every call (two processes sharing one card need gloo) and
a CPU tensor goes as it is. Nothing catches a failed collective to retry
it another way.
"""

from __future__ import annotations

import collections
from typing import Dict

import torch
import torch.distributed as dist

FAMILIES = ("all_reduce", "all_gather", "reduce_scatter", "p2p")
_COUNTS: collections.Counter = collections.Counter()


def counts() -> Dict[str, int]:
    """Calls of each family since the last ``reset_counts``."""
    return {f: _COUNTS[f] for f in FAMILIES}


def reset_counts() -> None:
    _COUNTS.clear()


def transport(group=None, device="cpu") -> str:
    """How a tensor on ``device`` travels in ``group``."""
    backend = dist.get_backend(group)
    if backend != "nccl" and torch.device(device).type == "cuda":
        return f"{backend}, staged through pinned host memory"
    return backend


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) != "nccl"


def _host(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``t`` reduced over ``group``."""
    _COUNTS["all_reduce"] += 1
    if _staged(t, group):
        buf = _host(t)
        dist.all_reduce(buf, op=op, group=group)
        return buf.to(t.device)
    out = t.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order, contiguous."""
    _COUNTS["all_gather"] += 1
    world = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    staged = _staged(t, group)
    if staged:
        src = _host(src)
    out = torch.empty((world * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      pin_memory=staged, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device).movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``t`` summed over ``group``, this rank's 1/world block along ``dim``."""
    _COUNTS["reduce_scatter"] += 1
    world = dist.get_world_size(group)
    src = t.movedim(dim, 0).contiguous()
    staged = _staged(t, group)
    if staged:
        src = _host(src)
    out = torch.empty((src.shape[0] // world,) + tuple(src.shape[1:]), dtype=src.dtype,
                      pin_memory=staged, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(t.device).movedim(0, dim).contiguous()


def tag(*fields: int) -> int:
    """One transfer's tag from at most three small fields (which transfer,
    then e.g. layer and hop, or microbatch), each in [0, 1024)."""
    if len(fields) > 3 or not all(0 <= f < 1024 for f in fields):
        raise ValueError(f"tag fields {fields}: at most three, each in [0, 1024)")
    out = 0
    for f in fields:
        out = out * 1024 + f
    return out


def _peer(group, offset: int) -> int:
    """The global rank ``offset`` places after this one in ``group``."""
    n = dist.get_world_size(group)
    return dist.get_global_rank(group, (dist.get_rank(group) + offset) % n)


def send(t: torch.Tensor, group, offset: int, tag: int) -> None:
    """``t`` to the rank ``offset`` after this one in ``group``."""
    _COUNTS["p2p"] += 1
    buf = _host(t) if _staged(t, group) else t.contiguous()
    dist.send(buf, _peer(group, offset), group=group, tag=tag)


def recv(shape, dtype, device, group, offset: int, tag: int) -> torch.Tensor:
    """A new tensor from the rank ``offset`` after this one in ``group``."""
    _COUNTS["p2p"] += 1
    staged = torch.device(device).type == "cuda" and dist.get_backend(group) != "nccl"
    buf = torch.empty(shape, dtype=dtype, pin_memory=staged,
                      device="cpu" if staged else device)
    dist.recv(buf, _peer(group, offset), group=group, tag=tag)
    return buf.to(device)


def shift(t: torch.Tensor, group, offset: int, tag: int) -> torch.Tensor:
    """Every rank of ``group`` sends ``t`` to the rank ``offset`` after it
    and returns what the rank ``offset`` before it sent (both posted before
    either is waited on: the ring has no first sender)."""
    _COUNTS["p2p"] += 2
    staged = _staged(t, group)
    src = _host(t) if staged else t.contiguous()
    out = torch.empty(src.shape, dtype=src.dtype, pin_memory=staged, device=src.device)
    works = [dist.isend(src, _peer(group, offset), group=group, tag=tag),
             dist.irecv(out, _peer(group, -offset), group=group, tag=tag)]
    for w in works:
        w.wait()
    return out.to(t.device)


def reduce_f32(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` in f32, cast once to ``t``'s dtype."""
    return all_reduce(t.float(), group).to(t.dtype)


class CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_f32(g, ctx.group), None


class ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward (f32, cast once); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherShards(torch.autograd.Function):
    """All-gather along ``dim`` forward; the gradient reduce-scattered back
    to this rank's block (summed over the group) backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.float(), ctx.dim, ctx.group).to(g.dtype), None, None


class GatherDim(torch.autograd.Function):
    """All-gather along ``dim`` forward; this rank's slice of the gradient
    backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


class Shift(torch.autograd.Function):
    """``shift`` by ``offset`` forward; the gradient shifted back by
    ``-offset`` backward (tagged ``bwd_tag``)."""

    @staticmethod
    def forward(ctx, x, group, offset, fwd_tag, bwd_tag):
        ctx.group, ctx.offset, ctx.tag = group, offset, bwd_tag
        return shift(x, group, offset, fwd_tag)

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.group, -ctx.offset, ctx.tag), None, None, None, None
