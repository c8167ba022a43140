"""The training step: loss and gradients of the trainable subtrees, global-norm
clipping, AdamW, gradient accumulation and the non-finite guard.

Counterpart of ``icl_speech_text_llm_tpu/training/step.py``, held to the
semantics of its optax chain ``MultiSteps(chain(clip_by_global_norm, adamw))``:

- clipping: ``g · max_norm / ‖g‖`` when ``‖g‖ ≥ max_norm``, else ``g``
  (optax ``clip_by_global_norm``, not ``clip_grad_norm_``'s ``+ 1e-6``);
- AdamW: bias-corrected moments, ``eps`` outside the square root, decoupled
  decay on every trainable leaf, lr from the schedule at the count of
  optimizer UPDATES (0 first, so HF-style warmup makes update 0 a no-op);
- accumulation: the running mean of k micro-batch gradients, one update on
  every k-th micro-step; ``state.step`` counts micro-steps;
- a non-finite loss makes the micro-step a no-op: parameters, moments and
  the accumulation buffer stay as they were, ``skipped_nonfinite`` = 1.

Data parallelism (``mesh``, the ``dp`` axis of ``parallel/mesh.py``): each
rank steps its rows of the global batch, and the step is the JAX package's
step over the whole global batch, whose loss is the token mean
``Σ nll·mask / max(Σ mask, 1)`` over every rank's rows. Averaging per-rank
means (plain DDP) would be wrong wherever the ranks hold different counts
of label tokens, so the step all-reduces the count of label tokens first,
weights its rank's loss by its count over the global count, and sums the
gradients of the weighted losses over the ranks (one all-reduce, which also
carries the loss and a non-finite flag): every rank then takes the same
skip decision and the same update, and reports the global loss and the
norm of the summed gradients.

FSDP and tensor parallelism (a mesh with fsdp or tp > 1,
``parallel/sharding.py``): the batch is the rank's rows over (dp, fsdp),
the trainable leaves are the rank's blocks by the rule table, and the
loss runs under the mesh's shard context. The label count and the
gradients are summed over the batch axes (fsdp, then dp; the dp-only
sums above are this with fsdp = 1): an FSDP-sharded leaf's gradient
arrives reduce-scattered over fsdp (its gather's backward) and is summed
over dp in a buffer of its own, every other leaf's over fsdp and dp. A tp-replicated trainable leaf (a LoRA factor whole on every tp
rank) gets its sum over tp from its copy into the tp region in the layer
code, and the Q-Former's gradient is already whole there (the decoder
input's gradient is complete on every tp rank), so each comes out equal on
the tp ranks. ``grad_norm`` counts every element once: a leaf's squares
are summed over the axes it is cut over, a replicated leaf's taken once.
Clipping uses that norm, AdamW steps the local blocks, and the non-finite
flag is summed over the whole world.

Pipeline parallelism (``pipeline=(mesh, n_micro)``, the JAX package's
argument; a mesh with pp > 1): the loss is the GPipe decoder's
(``models/salmonn.py``), the same on every stage; a stage's LoRA leaves
are its layers' slice (``sharding.stage_params``) and get their gradient
there alone, while a leaf every stage holds whole (the Q-Former, which
stage 0 alone runs) has its gradient summed over pp, non-zero on stage 0
alone. The norm counts each stage's slices once (``cut_axes``).

Sequence parallelism (``sp=(mesh, axis)``): the ranks of ``axis`` hold
the same rows and whole weights, each runs the decoder on its positions,
and every gradient is a partial sum over the axis, summed there (the
loss is already summed by the loss function); the mesh's other axes are
batch axes as above.

PyTorch idiom: the trainable leaves are f32 tensors that require grad, the
step updates them and the optimizer state in place (no second copy of the
weights) and returns the same ``TrainState``.

Phases: ``port/step.forward`` (the loss), ``port/step.backward``
(``torch.autograd.grad``) and ``port/step.update`` (the finiteness check,
the norm, the ``.item()`` reads, accumulation, clipping and AdamW) are
spans on every path (``utils/perf.py:span``, where a profiler records).
On CUDA with no mesh the step also marks CUDA events at their edges:
``step.timings()`` lists each step's [forward ms, backward ms, update ms],
read once the loop is over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.packing import IGNORE_INDEX
from ..models.salmonn import TRAINABLE_KEYS, SalmonnConfig, salmonn_train_loss
from ..parallel.mesh import DP_AXIS, FSDP_AXIS, PP_AXIS, TP_AXIS
from ..parallel.sharding import (
    context_of,
    cut_axes,
    is_sharded,
    is_staged,
    leaf_axes,
    shard_context,
    tree_paths,
)
from ..parallel import collectives
from ..utils.perf import StepEvents, device_events, span

#: Subtrees that train by default (everything else is frozen), as in the JAX
#: package: Whisper/BEATs/LLM frozen, Q-Former and LoRA train.
DEFAULT_TRAINABLE_KEYS = TRAINABLE_KEYS


@dataclass
class OptimizerSettings:
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    grad_accum_steps: int = 1
    schedule: Optional[Callable[[int], float]] = None  # update count → lr
    b1: float = 0.9
    b2: float = 0.999


EPS = 1e-8  # optax adamw's default, outside the square root


def split_params(params: Dict[str, Any], trainable_keys=DEFAULT_TRAINABLE_KEYS
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    trainable = {k: v for k, v in params.items() if k in trainable_keys}
    frozen = {k: v for k, v in params.items() if k not in trainable_keys}
    return trainable, frozen


def merge_params(frozen: Dict[str, Any], trainable: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(frozen)
    out.update(trainable)
    return out


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict of tensors, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ_leaves Σ x²) in f32 (optax ``global_norm``)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class AdamW:
    """``MultiSteps(chain(clip_by_global_norm(max_norm), adamw(...)))`` on a
    tree of f32 tensors, updated in place. State: ``count`` (updates made),
    ``mini_step`` (micro-steps since the last update) and the trees ``mu``,
    ``nu`` and, with accumulation, ``acc`` (running mean of the gradients)."""

    def __init__(self, settings: OptimizerSettings):
        self.s = settings

    def init(self, trainable: Dict[str, Any]) -> Dict[str, Any]:
        def zeros(t):
            return torch.zeros_like(t, dtype=torch.float32)

        state = {"count": 0, "mini_step": 0, "mu": tree_map(zeros, trainable),
                 "nu": tree_map(zeros, trainable)}
        if self.s.grad_accum_steps > 1:
            state["acc"] = tree_map(zeros, trainable)
        return state

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any],
               params: List[torch.Tensor]) -> None:
        """One micro-step: ``accumulate``, then ``apply`` on the gradients
        it gives, clipped by their global norm."""
        grads = self.accumulate(grads, state)
        if grads is not None:
            self.apply(grads, state, params, global_norm(grads))

    @torch.no_grad()
    def accumulate(self, grads: List[torch.Tensor], state: Dict[str, Any]
                   ) -> Optional[List[torch.Tensor]]:
        """The gradients to apply after this micro-step (f32): ``grads``
        without accumulation, the running mean every k-th micro-step, else
        None."""
        k = self.s.grad_accum_steps
        if k > 1:
            acc = tree_leaves(state["acc"])
            n = state["mini_step"]
            for a, g in zip(acc, grads):
                a.add_((g.float() - a) / (n + 1))
            if n < k - 1:
                state["mini_step"] = n + 1
                return None
            grads = acc
        return [g.float() for g in grads]

    @torch.no_grad()
    def apply(self, grads: List[torch.Tensor], state: Dict[str, Any],
              params: List[torch.Tensor], norm: torch.Tensor) -> None:
        """Clip ``grads`` by their global ``norm``, then one AdamW update."""
        s, k = self.s, self.s.grad_accum_steps
        if not bool(norm < s.max_grad_norm):
            grads = [(g / norm) * s.max_grad_norm for g in grads]
        lr = (self.s.learning_rate if self.s.schedule is None
              else float(self.s.schedule(state["count"])))
        t = state["count"] + 1
        # bias corrections in f32, as optax computes them (1 − 0.999 loses
        # digits there, and the moments are divided by exactly that)
        bc1, bc2 = (float(np.float32(1.0) - np.float32(b) ** np.float32(t)) for b in (s.b1, s.b2))
        for p, g, mu, nu in zip(params, grads, tree_leaves(state["mu"]),
                                tree_leaves(state["nu"])):
            mu.mul_(s.b1).add_(g, alpha=1.0 - s.b1)
            nu.mul_(s.b2).add_(g * g, alpha=1.0 - s.b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS) + s.weight_decay * p
            p.add_(u, alpha=-lr)
        state["count"] = t
        if k > 1:
            state["mini_step"] = 0
            for a in tree_leaves(state["acc"]):
                a.zero_()


@dataclass
class TrainState:
    trainable: Dict[str, Any]  # f32 leaves that require grad
    opt_state: Dict[str, Any]
    step: int = 0  # micro-steps taken


def init_train_state(params: Dict[str, Any], optimizer: AdamW,
                     trainable_keys=DEFAULT_TRAINABLE_KEYS) -> Tuple[TrainState, Dict[str, Any]]:
    """Split ``params``: the trainable subtrees become f32 leaves that
    require grad (copies, so the caller's tree is left alone), the rest is
    returned frozen."""
    trainable, frozen = split_params(params, trainable_keys)
    trainable = tree_map(
        lambda t: t.detach().to(torch.float32, copy=True).requires_grad_(True), trainable)
    return TrainState(trainable, optimizer.init(trainable), 0), frozen


def _loss_and_grads(cfg, loss_fn, remat, state: TrainState, frozen: Dict[str, Any],
                    batch: Dict[str, torch.Tensor], weight=None,
                    events: Optional[StepEvents] = None, **kw):
    """The loss (× ``weight``) and its gradients over the trainable leaves;
    ``events`` marked after each; ``kw`` the loss function's ``pipeline`` /
    ``sp``."""
    leaves = tree_leaves(state.trainable)
    with span("step.forward"):
        loss = loss_fn(cfg, merge_params(frozen, state.trainable), batch, remat=remat, **kw)
        if weight is not None:
            loss = loss * weight
    if events is not None:
        events.mark()
    with span("step.backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    if events is not None:
        events.mark()
    return loss.detach(), grads


def make_train_probe(cfg: SalmonnConfig, loss_fn: Callable = salmonn_train_loss,
                     remat=False, mesh=None, pipeline=None) -> Callable:
    """The step's forward and backward without its optimizer update:
    (state, frozen, batch) → (loss, gradients), changing no state. What
    ``--auto_batch`` runs at each candidate batch size; under a sharded
    ``mesh`` on the rank's blocks and rows (no gradient reduction), through
    the ``pipeline`` where one is given."""
    ctx = context_of(mesh) if is_sharded(mesh) else None
    kw = {} if pipeline is None else {"pipeline": pipeline}

    def probe(state: TrainState, frozen: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        with shard_context(ctx):
            return _loss_and_grads(cfg, loss_fn, remat, state, frozen, batch, **kw)

    return probe


def _sum_over(t: torch.Tensor, ctx, *axes) -> torch.Tensor:
    """``t`` summed over each axis in turn: dp always (a dp group of one
    reduces too, as the data-parallel step always has), fsdp and tp where
    their size is > 1."""
    for axis in axes:
        if ctx.sizes[axis] > 1 or axis == DP_AXIS:
            t = collectives.all_reduce(t, ctx.groups[axis])
    return t


def sharded_norm_fn(trainable: Dict[str, Any], ctx) -> Callable:
    """The global norm of a tree of local blocks cut by the rule table and
    the pipeline's stages: each leaf's squares summed over the axes it is
    cut over, a replicated leaf's taken once (one all-reduce an axis
    combination)."""
    axes = [cut_axes(path, leaf, ctx) for path, leaf in tree_paths(trainable)]

    def norm(grads):
        groups: Dict[Tuple[str, ...], torch.Tensor] = {}
        for a, g in zip(axes, grads):
            sq = torch.sum(g.float() * g.float())
            groups[a] = groups[a] + sq if a in groups else sq
        total = sum(_sum_over(sq, ctx, *a) for a, sq in groups.items())
        return torch.sqrt(total)

    return norm


def _sum_leaves(grads, which, ctx, axis):
    """``grads`` with the leaves ``which`` marks summed over ``axis`` (one
    all-reduce of them all)."""
    picked = [g for g, w in zip(grads, which) if w]
    if not picked:
        return grads
    flat = _sum_over(torch.cat([g.reshape(-1) for g in picked]), ctx, axis)
    summed = iter(v.view_as(g) for v, g in zip(flat.split([g.numel() for g in picked]), picked))
    return [next(summed) if w else g for g, w in zip(grads, which)]


def _mesh_loss_and_grads(cfg, loss_fn, remat, ctx, state, frozen, batch, **kw):
    """This rank's share of the global token-mean loss and its gradients
    reduced over the batch axes (and over pp or the sp axis where they are
    partial sums there): (global loss, reduced local gradients, skip
    flag), the same on every rank (module docstring); ``kw`` the loss
    function's ``pipeline`` / ``sp``."""
    sp = kw.get("sp")
    count = (batch["shifted_labels"] != IGNORE_INDEX).sum().to(torch.float32)
    total = _sum_over(count, ctx, FSDP_AXIS, DP_AXIS)
    layered = sp is None and (ctx.fsdp > 1 or ctx.tp > 1)
    with shard_context(ctx if layered else None):
        loss, grads = _loss_and_grads(cfg, loss_fn, remat, state, frozen, batch,
                                      weight=count / total.clamp(min=1), **kw)
    paths = list(tree_paths(state.trainable))
    fsdp_cut = [layered and ctx.fsdp > 1 and FSDP_AXIS in leaf_axes(path, leaf)
                for path, leaf in paths]
    whole = [g for g, cut in zip(grads, fsdp_cut) if not cut]
    flat = torch.cat([g.reshape(-1) for g in whole]
                     + [loss.reshape(1), (~torch.isfinite(loss)).to(torch.float32).reshape(1)])
    flat = _sum_over(flat, ctx, FSDP_AXIS, DP_AXIS)
    flag = _sum_over(flat[-1:], ctx, TP_AXIS)
    cut = [g for g, c in zip(grads, fsdp_cut) if c]
    if cut:
        flat_cut = _sum_over(torch.cat([g.reshape(-1) for g in cut]), ctx, DP_AXIS)
        cut = iter(v.view_as(g) for v, g in zip(flat_cut.split([g.numel() for g in cut]), cut))
    whole = iter(v.view_as(g) for v, g in zip(flat[:-2].split([g.numel() for g in whole]),
                                               whole))
    grads = [next(cut) if c else next(whole) for c in fsdp_cut]
    if sp is not None:  # every gradient a partial sum over the sp axis
        grads = _sum_leaves(grads, [True] * len(grads), ctx, sp[1])
    elif ctx.pp > 1:  # a leaf every stage holds whole: non-zero on stage 0 alone
        grads = _sum_leaves(grads, [not is_staged(path) for path, _ in paths], ctx, PP_AXIS)
    return flat[-2], grads, bool(flag[0] > 0)


def make_train_step(cfg: SalmonnConfig, optimizer: AdamW,
                    loss_fn: Callable = salmonn_train_loss, remat=False, mesh=None,
                    pipeline=None, sp=None) -> Callable:
    """Build the step: (state, frozen, batch) → (state, metrics) with metrics
    ``loss``, ``grad_norm`` (of the micro-batch gradients, before clipping),
    ``skipped_nonfinite`` and ``step`` (the micro-step it ran as); its
    ``timings()`` the phases' device ms of each step that ran on CUDA with
    no mesh (module docstring), waiting for the last step's update. With a
    ``mesh`` the batch is this rank's rows of the global batch, and the
    loss, gradients and skip are the global batch's (module docstring); a
    mesh with fsdp, tp or pp > 1 takes ``state`` and ``frozen`` as the
    rank's blocks (``shard_params``, then ``stage_params``).
    ``pipeline=(mesh, n_micro)`` (its mesh is the step's) GPipes the
    decoder; ``sp=(mesh, axis)`` cuts its activations along T over
    ``axis``, the weights whole on every rank."""
    if pipeline is not None and sp is not None:
        raise ValueError("pipeline and sp are two ways to run the decoder: pass one")
    kw = {}
    if pipeline is not None:
        if mesh is not None and mesh is not pipeline[0]:
            raise ValueError("the pipeline's mesh must be the step's")
        mesh, kw = pipeline[0], {"pipeline": pipeline}
    if sp is not None:
        if mesh is not None and mesh is not sp[0]:
            raise ValueError("the sp mesh must be the step's")
        if sp[1] in (DP_AXIS, FSDP_AXIS):
            raise ValueError(f"sp over {sp[1]!r}: a batch axis splits the rows, not the "
                             "sequence")
        mesh, kw = sp[0], {"sp": sp}
    ctx = context_of(mesh)
    phases: List[StepEvents] = []

    def step(state: TrainState, frozen: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        sharded = sp is None and is_sharded(mesh)
        norm_fn = sharded_norm_fn(state.trainable, ctx) if sharded else global_norm
        if ctx is None:
            events = device_events(tree_leaves(state.trainable)[0].device)
            if events is not None:
                events.mark()
            loss, grads = _loss_and_grads(cfg, loss_fn, remat, state, frozen, batch,
                                          events=events)
            nonfinite = False
        else:
            events = None
            loss, grads, nonfinite = _mesh_loss_and_grads(cfg, loss_fn, remat, ctx, state,
                                                          frozen, batch, **kw)
        with span("step.update"):
            ok = not nonfinite and bool(torch.isfinite(loss))
            norm = norm_fn(grads)
            metrics = {"loss": loss.item(), "grad_norm": norm.item(),
                       "skipped_nonfinite": 0.0 if ok else 1.0, "step": state.step}
            if ok:
                applied = optimizer.accumulate(grads, state.opt_state)
                if applied is not None:  # the micro-step's norm clips unless it was accumulated
                    optimizer.apply(applied, state.opt_state, tree_leaves(state.trainable),
                                    norm if optimizer.s.grad_accum_steps == 1
                                    else norm_fn(applied))
        if events is not None:
            events.mark()
            phases.append(events)
        state.step += 1
        return state, metrics

    def timings() -> List[List[float]]:
        if phases:
            phases[-1].events[-1].synchronize()
        return [events.millis() for events in phases]

    step.timings = timings
    return step
