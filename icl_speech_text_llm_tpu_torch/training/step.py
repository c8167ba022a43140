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

PyTorch idiom: the trainable leaves are f32 tensors that require grad, the
step updates them and the optimizer state in place (no second copy of the
weights) and returns the same ``TrainState``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.packing import IGNORE_INDEX
from ..models.salmonn import TRAINABLE_KEYS, SalmonnConfig, salmonn_train_loss
from ..parallel.mesh import DP_AXIS

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
        s, k = self.s, self.s.grad_accum_steps
        if k > 1:
            acc = tree_leaves(state["acc"])
            n = state["mini_step"]
            for a, g in zip(acc, grads):
                a.add_((g.float() - a) / (n + 1))
            if n < k - 1:
                state["mini_step"] = n + 1
                return
            grads = acc
        grads = [g.float() for g in grads]
        norm = global_norm(grads)
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
                    batch: Dict[str, torch.Tensor], weight=None):
    """The loss (× ``weight``) and its gradients over the trainable leaves."""
    leaves = tree_leaves(state.trainable)
    loss = loss_fn(cfg, merge_params(frozen, state.trainable), batch, remat=remat)
    if weight is not None:
        loss = loss * weight
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), grads


def make_train_probe(cfg: SalmonnConfig, loss_fn: Callable = salmonn_train_loss,
                     remat=False) -> Callable:
    """The step's forward and backward without its optimizer update:
    (state, frozen, batch) → (loss, gradients), changing no state. What
    ``--auto_batch`` runs at each candidate batch size."""

    def probe(state: TrainState, frozen: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        return _loss_and_grads(cfg, loss_fn, remat, state, frozen, batch)

    return probe


def _dp_loss_and_grads(cfg, loss_fn, remat, group, state, frozen, batch):
    """This rank's share of the global token-mean loss and the gradients
    summed over ``group``: (global loss, summed gradients, skip flag), the
    same on every rank."""
    count = (batch["shifted_labels"] != IGNORE_INDEX).sum().to(torch.float32)
    total = count.clone()
    dist.all_reduce(total, group=group)
    loss, grads = _loss_and_grads(cfg, loss_fn, remat, state, frozen, batch,
                                  weight=count / total.clamp(min=1))
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.reshape(1), (~torch.isfinite(loss)).to(torch.float32).reshape(1)])
    dist.all_reduce(flat, group=group)
    grads = [v.view_as(g) for v, g in zip(flat[:-2].split([g.numel() for g in grads]), grads)]
    return flat[-2], grads, bool(flat[-1] > 0)


def make_train_step(cfg: SalmonnConfig, optimizer: AdamW,
                    loss_fn: Callable = salmonn_train_loss, remat=False, mesh=None) -> Callable:
    """Build the step: (state, frozen, batch) → (state, metrics) with metrics
    ``loss``, ``grad_norm`` (of the micro-batch gradients, before clipping),
    ``skipped_nonfinite`` and ``step`` (the micro-step it ran as). With a
    ``mesh`` the batch is this rank's rows of the global batch, and the
    loss, gradients and skip are the global batch's (module docstring)."""
    group = mesh.get_group(DP_AXIS) if mesh is not None else None

    def step(state: TrainState, frozen: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        if group is None:
            loss, grads = _loss_and_grads(cfg, loss_fn, remat, state, frozen, batch)
            nonfinite = False
        else:
            loss, grads, nonfinite = _dp_loss_and_grads(cfg, loss_fn, remat, group, state,
                                                        frozen, batch)
        ok = not nonfinite and bool(torch.isfinite(loss))
        metrics = {"loss": loss.item(), "grad_norm": global_norm(grads).item(),
                   "skipped_nonfinite": 0.0 if ok else 1.0, "step": state.step}
        if ok:
            optimizer.update(grads, state.opt_state, tree_leaves(state.trainable))
        state.step += 1
        return state, metrics

    return step
