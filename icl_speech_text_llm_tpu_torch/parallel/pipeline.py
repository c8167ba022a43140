"""Pipeline parallelism for the stacked decoder (GPipe schedule).

Counterpart of ``icl_speech_text_llm_tpu/parallel/pipeline.py``: the mesh's
``pp`` axis cuts the decoder's layers into stages of ``n_layers / pp``
contiguous layers, and the batch into ``n_micro`` microbatches along its
rows. JAX runs the schedule as one SPMD ``scan`` whose ticks rotate the
activations with ``ppermute`` and gets the backward from autodiff; here it
is an explicit GPipe loop on each stage, one ``torch.autograd.Function``
for the whole schedule:

- forward: every microbatch in order: receive its activation from stage − 1
  (stage 0 takes its rows of the input), run the stage's layers through the
  port's layer loop (``run_layer_stack``: K1 on the card, the FSDP and
  tensor-parallel layer code inside the stage) with autograd recording,
  send the output to stage + 1;
- backward: the microbatches in reverse: receive the output's gradient
  from stage + 1 (the last stage takes its rows of the incoming one),
  differentiate the microbatch's local graph (K5/K6 on the card), send the
  input's gradient to stage − 1.

Every send and receive runs outside autograd in one fixed order on every
stage, tagged with its direction and microbatch (``collectives.tag``). The
last stage alone holds the decoder's output; ``pipeline_decoder_forward``
sums it over pp (zeros elsewhere) so every stage returns it, as JAX's does,
and the train loss (``last_stage_loss``) sums the last stage's loss over
pp instead. A stage's layer and LoRA leaves get their gradient on that
stage alone, and the input's gradient lands on stage 0 alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import torch

from ..models import llama  # a module: llama imports this package in turn
from ..models.common import rms_norm
from . import collectives as C
from .mesh import PP_AXIS
from .sharding import context_of, current_shard, shard_context

_FWD, _BWD = 3, 4  # the first field of a transfer's tag


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _grad_leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` that require grad, in insertion order."""
    out: List[torch.Tensor] = []
    _tree_map(lambda t: out.append(t) if t.requires_grad else None, tree)
    return out


def _swap_grad_leaves(tree, it):
    """``tree`` with each leaf that requires grad replaced by ``next(it)``."""
    return _tree_map(lambda t: next(it) if t.requires_grad else t, tree)


def _stage_slice(tree, cfg: llama.DecoderConfig, ctx):
    """The stage's layers of a stacked tree given whole (``n_layers`` on
    dim 0: JAX's replicated input, sliced here as its ``shard_map`` slices
    it) or already cut to the stage (``sharding.stage_params``)."""
    n = cfg.n_layers // ctx.pp

    def cut(leaf):
        if leaf.shape[0] == n:
            return leaf
        if leaf.shape[0] == cfg.n_layers:
            return leaf.narrow(0, ctx.pp_rank * n, n)
        raise ValueError(f"a stacked leaf of {leaf.shape[0]} layers is neither the decoder's "
                         f"{cfg.n_layers} nor a stage's {n}")

    return _tree_map(cut, tree)


@dataclass
class _Schedule:
    """One stage's share of a GPipe call: its layers, the microbatch rows,
    the pp group and the shard context its layers run under."""

    cfg: llama.DecoderConfig
    layers: Dict[str, Any]
    lora: Optional[Dict[str, Any]]
    lora_scaling: float
    remat: Any
    lengths: torch.Tensor
    n_micro: int
    stage: int
    n_stages: int
    group: Any
    shard: Any
    grad: bool

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.n_stages - 1

    def rows(self, m: int, batch: int) -> slice:
        mb = batch // self.n_micro
        return slice(m * mb, (m + 1) * mb)

    def run(self, x: torch.Tensor, m: int, leaves: List[torch.Tensor]) -> torch.Tensor:
        """The stage's layers on microbatch m's input ``x`` (mb, T, D),
        its trainable leaves replaced by ``leaves``."""
        it = iter(leaves)
        layers = _swap_grad_leaves(self.layers, it)
        lora = _swap_grad_leaves(self.lora, it)
        mb, T, _ = x.shape
        rows = slice(m * mb, (m + 1) * mb)
        positions = torch.arange(T, device=x.device)[None].expand(mb, T)
        return llama.run_layer_stack(self.cfg, layers, x, positions, self.lengths[rows], lora,
                                     self.lora_scaling, self.remat)


class _GPipe(torch.autograd.Function):
    """The whole schedule on this stage: (plan, x, anchor, *leaves) → the
    stage's layers' output over the batch on the last stage, a 0-dim zero
    elsewhere. ``anchor`` requires grad whenever grad mode is on, so every
    stage of a pipeline takes part in the backward."""

    @staticmethod
    def forward(ctx, plan: _Schedule, x, anchor, *leaves):
        det = [t.detach().requires_grad_() for t in leaves]
        B, T, D = x.shape
        saved = []
        with torch.set_grad_enabled(plan.grad), shard_context(plan.shard):
            for m in range(plan.n_micro):
                rows = plan.rows(m, B)
                if plan.first:
                    xin = x[rows].detach()
                else:
                    xin = C.recv((rows.stop - rows.start, T, D), x.dtype, x.device, plan.group,
                                 -1, C.tag(_FWD, m))
                if plan.grad:
                    xin.requires_grad_()
                out = plan.run(xin, m, det)
                if not plan.last:
                    C.send(out.detach(), plan.group, 1, C.tag(_FWD, m))
                saved.append((xin, out))
        ctx.plan, ctx.saved, ctx.det, ctx.x_grad = plan, saved, det, x.requires_grad
        if plan.last:
            return torch.cat([out.detach() for _, out in saved])
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, grad):
        plan, saved, det = ctx.plan, ctx.saved, ctx.det
        acc: List[Optional[torch.Tensor]] = [None] * len(det)
        gx = [None] * plan.n_micro
        with shard_context(plan.shard):
            for m in reversed(range(plan.n_micro)):
                xin, out = saved[m]
                if plan.last:
                    g = grad[plan.rows(m, grad.shape[0])]
                else:
                    g = C.recv(out.shape, out.dtype, out.device, plan.group, 1, C.tag(_BWD, m))
                gs = torch.autograd.grad(out, [xin] + det, g, allow_unused=True)
                saved[m] = None  # the microbatch's graph is freed with it
                if not plan.first:
                    C.send(gs[0], plan.group, -1, C.tag(_BWD, m))
                gx[m] = gs[0]
                for i, gi in enumerate(gs[1:]):
                    if gi is not None:
                        acc[i] = gi if acc[i] is None else acc[i] + gi
        grad_x = torch.cat(gx) if plan.first and ctx.x_grad else None
        return (None, grad_x, None, *acc)


def pipeline_stage_forward(mesh, cfg: llama.DecoderConfig, params: Dict[str, Any],
                           inputs_embeds: torch.Tensor, lengths: torch.Tensor, n_micro: int,
                           lora: Optional[Dict[str, Any]] = None, lora_scaling: float = 1.0,
                           remat=False) -> torch.Tensor:
    """This stage's result of the GPipe decoder over ``mesh``'s pp axis: on
    the last stage the final-normed hidden (B, T, dim), on the others a
    0-dim zero that carries the backward into the schedule.
    ``inputs_embeds`` is read on stage 0 only (the others may pass any
    tensor of its shape and dtype, e.g. an expanded zero); ``lengths`` (B,)
    and the batch rows are every stage's. ``params["layers"]`` and ``lora``
    are whole or the stage's slice (``sharding.stage_params``). Under a
    shard context (fsdp, tp within the stage) the layers run sharded."""
    ctx = context_of(mesh)
    if ctx is None:
        raise ValueError("the pipeline needs a mesh")
    n_stages = ctx.pp
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers not divisible by pp={n_stages}")
    B = inputs_embeds.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    layers = _stage_slice(params["layers"], cfg, ctx)
    lora = _stage_slice(lora, cfg, ctx)
    leaves = _grad_leaves(layers) + _grad_leaves(lora)
    plan = _Schedule(llama._local_cfg(cfg), layers, lora, lora_scaling, remat, lengths,
                     n_micro, ctx.pp_rank, n_stages, ctx.groups[PP_AXIS], current_shard(),
                     torch.is_grad_enabled())
    anchor = torch.zeros((), device=inputs_embeds.device, requires_grad=plan.grad)
    out = _GPipe.apply(plan, inputs_embeds, anchor, *leaves)
    return rms_norm(out, params["final_norm"], cfg.rms_eps) if plan.last else out


def last_stage_loss(mesh, loss_fn: Callable[[torch.Tensor], torch.Tensor],
                    out: torch.Tensor) -> torch.Tensor:
    """``loss_fn`` of the last stage's hidden (``pipeline_stage_forward``),
    summed over pp (0 from the other stages, in f32): the loss on every
    stage, its backward reaching every stage's schedule."""
    ctx = context_of(mesh)
    loss = loss_fn(out) if ctx.pp_rank == ctx.pp - 1 else out.float() * 0
    return loss if ctx.pp == 1 else C.ReduceFromGroup.apply(loss, ctx.groups[PP_AXIS])


def pipeline_decoder_forward(mesh, cfg: llama.DecoderConfig, params: Dict[str, Any],
                             inputs_embeds: torch.Tensor, lengths: torch.Tensor, n_micro: int,
                             lora: Optional[Dict[str, Any]] = None, lora_scaling: float = 1.0,
                             remat=False) -> torch.Tensor:
    """The decoder stack over ``mesh``'s (dp, pp) with a microbatched GPipe
    schedule: equal to ``decoder_forward(...)[0]`` (no cache), the
    final-normed hidden on every stage (the last stage's, summed over pp
    with zeros elsewhere). ``inputs_embeds`` (B, T, dim) is this rank's
    rows; B % ``n_micro`` and n_layers % pp must be 0, as in JAX."""
    out = pipeline_stage_forward(mesh, cfg, params, inputs_embeds, lengths, n_micro, lora,
                                 lora_scaling, remat)
    ctx = context_of(mesh)
    if ctx.pp == 1:
        return out
    if ctx.pp_rank != ctx.pp - 1:
        out = out.expand(inputs_embeds.shape) * 0
    return C.ReduceFromGroup.apply(out, ctx.groups[PP_AXIS])
