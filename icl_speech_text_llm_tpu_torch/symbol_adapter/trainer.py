"""Unified phase-driven trainer for symbol-adapter research.

Counterpart of ``icl_speech_text_llm_tpu/symbol_adapter/trainer.py`` (ref:
models/symbolAdapter/training/unified_trainer.py:53-507):

- per-phase trainables (``lora`` / ``mlp_adapter`` / both): freezing is
  WHICH subtree gets gradients; a subtree outside the phase is not touched;
- a fresh optimizer per schedule step, ``chain(clip_by_global_norm, adamw)``
  (``training/step.py:AdamW`` with no accumulation) with the per-epoch
  warmup-restart schedule for LoRA phases, else cosine;
- every update applied, as the reference's step does: no non-finite guard
  (``training/step.py:make_train_step``'s is not used here);
- per-batch symbol replacement of a random subset of the labels, with
  forced regeneration every ``100 × grad_accum`` batches in dynamic phases
  (ref :286-292): ``gradient_accumulation_steps`` sets only that cadence,
  gradients are never accumulated;
- trainable-only checkpoints with the config and symbol mappings (ref
  :448-482), in the ``state.npy`` layout both packages read.

The trainable leaves are f32 masters (copies that require grad, as
``training/step.py:init_train_state`` makes); ``_publish`` folds them back
into the model in the dtype it holds each subtree in.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.collate import ICLSample, collate_icl_batch
from ..data.packing import PackConfig
from ..data.prompts import PromptPlan
from ..models.factory import _float_dtype
from ..training.checkpoint import save_checkpoint
from ..training.schedulers import get_schedule
from ..training.step import AdamW, OptimizerSettings, tree_leaves, tree_map
from ..utils.perf import PerformanceTracker
from .configs import SymbolMode, TrainingConfig
from .losses import mlp_salmonn_train_loss
from .mlp_adapter import label_token_mask
from .schedulers import TrainingStep
from .symbol_manager import SymbolManager

logger = logging.getLogger(__name__)

FORCE_NEW_SYMBOLS_EVERY = 100  # × grad_accum batches (ref :286-292)


def replace_symbols_in_sample(
    sample: ICLSample, mappings: Dict[str, str], masked: Optional[set] = None
) -> ICLSample:
    """String-replace label words with symbols in a rendered ICLSample."""
    if masked is None:
        masked = set(mappings.keys())

    def rep(text: str) -> str:
        for original, symbol in mappings.items():
            if original in masked:
                text = text.replace(original, symbol)
        return text

    new_plan = PromptPlan(
        segments=[rep(s) for s in sample.plan.segments],
        slots=list(sample.plan.slots),
        prompt=rep(sample.plan.prompt),
    )
    return ICLSample(
        plan=new_plan,
        completion=rep(sample.completion),
        slot_audio=sample.slot_audio,
        extras=sample.extras,
    )


def _masters(tree):
    return tree_map(lambda t: t.detach().to(torch.float32, copy=True).requires_grad_(True), tree)


class UnifiedTrainer:
    def __init__(
        self,
        config: TrainingConfig,
        model,  # SalmonnModel
        mlp_params: Dict[str, Any],
        symbol_manager: SymbolManager,
        pack_cfg: PackConfig,
        validator=None,
    ):
        self.config = config
        self.model = model
        self.mlp_params = mlp_params
        self.symbol_manager = symbol_manager
        self.pack_cfg = pack_cfg
        self.validator = validator
        self.training_summary: List[Dict[str, Any]] = []
        self._symbol_token_ids = self._compute_symbol_token_ids()

    # ------------------------------------------------------------------
    def _compute_symbol_token_ids(self) -> List[int]:
        # both bare and space-prefixed encodings: symbols appear mid-sentence,
        # where space-merged pieces tokenize differently than standalone
        ids: List[int] = []
        for sym in self.symbol_manager.get_current_symbols().values():
            ids.extend(self.model.tokenizer.encode(sym, add_special_tokens=False))
            ids.extend(self.model.tokenizer.encode(" " + sym, add_special_tokens=False))
        return ids

    def _phase_trainables(self, step: TrainingStep) -> Dict[str, Any]:
        """Which subtrees get gradients this phase, as f32 masters."""
        trainable: Dict[str, Any] = {}
        if not step.freeze_lora:
            trainable["lora"] = _masters(self.model.params["lora"])
        if not step.freeze_mlp:
            trainable["mlp_adapter"] = _masters(self.mlp_params)
        if not trainable:  # degenerate phases still need something to optimize
            trainable["lora"] = _masters(self.model.params["lora"])
        return trainable

    def _make_optimizer(self, step: TrainingStep, steps_per_epoch: int) -> AdamW:
        lc = self.config.lora_config
        lr = step.learning_rate or lc.learning_rate
        if step.phase == "lora" and lc.warmup_per_epoch and steps_per_epoch > 0:
            schedule = get_schedule("per_epoch_warmup_restart", lr, 0, 0,
                                    steps_per_epoch=steps_per_epoch)
        else:
            total = max(1, steps_per_epoch * step.epochs)
            schedule = get_schedule("cosine", lr, min(100, total // 10), total)
        return AdamW(OptimizerSettings(
            learning_rate=lr, weight_decay=lc.weight_decay,
            max_grad_norm=step.max_grad_norm or 1.0, grad_accum_steps=1, schedule=schedule))

    def _make_step_fn(self, step: TrainingStep, optimizer: AdamW) -> Callable:
        cfg = self.model.cfg
        temperature = self.config.mlp_config.temperature
        use_mlp = not step.freeze_mlp or (not step.bypass_mlp and step.phase != "lora")
        # the MLP params current when the schedule step begins
        static_mlp = self.mlp_params if use_mlp else None

        def train_step(trainable, opt_state, static_params, batch):
            lora = trainable.get("lora", static_params.get("lora"))
            mlp = trainable.get("mlp_adapter", static_mlp)
            loss, disc, sims = mlp_salmonn_train_loss(
                cfg, static_params, batch,
                mlp_params=mlp if not step.bypass_mlp else None,
                temperature=temperature,
                bypass_mlp=step.bypass_mlp,
                lora_params=lora,
            )
            leaves = tree_leaves(trainable)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
            optimizer.update(grads, opt_state, leaves)
            return trainable, opt_state, loss.detach(), (disc, sims.detach())

        return train_step

    # ------------------------------------------------------------------
    def _device_batch(self, samples: List[ICLSample]) -> Dict[str, torch.Tensor]:
        batch = collate_icl_batch(samples, self.model.tokenizer, self.pack_cfg)
        label_mask = label_token_mask(batch.text_tokens, self._symbol_token_ids)
        arrays = {
            "text_tokens": batch.text_tokens,
            "gather_idx": batch.gather_idx,
            "seq_mask": batch.seq_mask,
            "shifted_labels": batch.labels_shifted,
            "wavs": batch.audio["wavs"],
            "label_mask": label_mask,
        }
        dev = self.model.engine.device
        return {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in arrays.items()}

    def train_step(self, step: TrainingStep, dataset) -> Dict[str, Any]:
        """Run one schedule step (possibly several epochs). Returns summary."""
        bs = self.config.data_config.batch_size
        steps_per_epoch = max(1, len(dataset) // bs)
        optimizer = self._make_optimizer(step, steps_per_epoch)
        trainable = self._phase_trainables(step)
        opt_state = optimizer.init(trainable)
        step_fn = self._make_step_fn(step, optimizer)
        tracker = PerformanceTracker(log_interval=0)

        use_symbols = step.use_symbols and (
            self.config.symbol_config.mode != SymbolMode.NO_SYMBOLS
        )
        accum = step.gradient_accumulation_steps or 1
        last_loss = float("nan")
        epoch_summaries = []
        for epoch in range(step.epochs):
            if step.dynamic_symbols and use_symbols:
                self.symbol_manager.get_symbols_for_epoch(epoch, force_new_symbols=True)
                self._symbol_token_ids = self._compute_symbol_token_ids()
            for b_idx in range(steps_per_epoch):
                samples = [dataset[b_idx * bs + j] for j in range(bs)]
                if use_symbols:
                    force_new = (
                        step.dynamic_symbols
                        and b_idx > 0
                        and b_idx % (FORCE_NEW_SYMBOLS_EVERY * accum) == 0
                    )
                    mappings = self.symbol_manager.get_symbols_for_epoch(
                        epoch, force_new_symbols=force_new
                    )
                    n_mask = max(1, len(mappings) // 8)
                    masked = set(
                        self.symbol_manager._rng.sample(list(mappings), n_mask)
                    )
                    samples = [
                        replace_symbols_in_sample(s, mappings, masked) for s in samples
                    ]
                batch = self._device_batch(samples)
                trainable, opt_state, loss, _ = step_fn(
                    trainable, opt_state, self.model.params, batch
                )
                last_loss = float(loss)
                tracker.update(loss=last_loss, examples=bs)

            val_metrics = {}
            if self.validator is not None:
                self._publish(trainable)
                val_metrics = self.validator.validate_model(epoch=epoch)
            epoch_summaries.append({"epoch": epoch, "loss": last_loss, "val": val_metrics})
            logger.info(
                f"[{step.phase} step {step.step_id}] epoch {epoch}: loss={last_loss:.4f}"
                + (f", val={val_metrics}" if val_metrics else "")
            )

        self._publish(trainable)
        summary = {
            "step_id": step.step_id,
            "phase": step.phase,
            "cycle": step.cycle,
            "epochs": epoch_summaries,
            "final_loss": last_loss,
            "perf": tracker.get_summary(),
        }
        self.training_summary.append(summary)
        return summary

    def _publish(self, trainable: Dict[str, Any]):
        """Fold trained subtrees back into the model/adapter state: LoRA in
        the dtype the model holds it in (model and engine share the tree),
        the MLP adapter as detached f32 tensors."""
        if "lora" in trainable:
            dt = _float_dtype(self.model.params["lora"])
            lora = tree_map(lambda t: t.detach().to(dt, copy=True), trainable["lora"])
            self.model.params = {**self.model.params, "lora": lora}
            self.model.engine.params = self.model.params
        if "mlp_adapter" in trainable:
            self.mlp_params = tree_map(lambda t: t.detach().clone(), trainable["mlp_adapter"])

    # ------------------------------------------------------------------
    def save_checkpoint_with_config(
        self, ckpt_dir: str, step: TrainingStep, loss: float
    ) -> str:
        """Trainable params + embedded config + symbol mappings (ref :448-482)."""
        name = f"{step.phase}_step{step.step_id}_cycle{step.cycle}"
        trainable = {"lora": self.model.params["lora"], "mlp_adapter": self.mlp_params}
        metadata = {
            "training_config": {
                "mode": self.config.mode.value,
                "symbol_mode": self.config.symbol_config.mode.value,
                "dataset_type": self.config.data_config.dataset_type,
                "model_type": self.config.model_type,
            },
            "symbol_mappings": self.symbol_manager.get_current_symbols(),
            "phase": step.phase,
        }
        return save_checkpoint(
            os.path.join(ckpt_dir, name), trainable, step=step.step_id,
            epoch=step.epochs, loss=loss, metadata=metadata,
        )
