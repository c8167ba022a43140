"""Symbol-training orchestrators: end-to-end training + inference twins.

Counterpart of ``icl_speech_text_llm_tpu/symbol_adapter/orchestrator.py``:
the model is built on an explicit ``device`` (default ``cuda``) with f32
LoRA (``trainable_dtype``), as the JAX package holds it, and the MLP
adapter is drawn from a ``torch.Generator`` seeded ``seed + 1``. Rebuild of
the reference orchestrators (ref: models/symbolAdapter/training/
symbol_training.py:97-512, orchestrator_training.py:213-300,
orchestrator_inference.py:35-411): schedule generation, per-step training
via UnifiedTrainer, epoch summaries, ASCII cycle/final tables, checkpoints
with embedded config + symbol mappings, and a checkpoint-restoring
inference run.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

import torch

from ..bridge import params_from_numpy
from ..data.factory import create_dataset
from ..data.packing import PackConfig
from ..evaluation import to_json_compatible
from ..models.factory import _float_dtype, create_model
from ..registry import DatasetSplit, DatasetType, get_dataset_config, parse_dataset_types
from ..training.checkpoint import load_checkpoint
from .configs import SymbolMode, TrainingConfig
from .mlp_adapter import init_mlp_adapter
from .schedulers import TrainingScheduler
from .symbol_manager import SymbolManager
from .trainer import UnifiedTrainer
from .validation import ValidationManager

logger = logging.getLogger(__name__)

_ABBREV = {  # dataset abbreviations for the summary tables (ref :361-495)
    "voxceleb": "VOX", "hvb": "HVB", "voxpopuli": "VP",
    "meld_emotion": "MELD-E", "meld": "MELD", "sqa": "SQA", "vp_nel": "NEL",
}


def extract_dataset_labels(dataset_types: List[DatasetType]) -> List[str]:
    """Union of valid labels across datasets (ref orchestrator_training:150-167)."""
    labels: List[str] = []
    for dt in dataset_types:
        cfg = get_dataset_config(dt)
        if cfg and cfg.valid_labels:
            for label in cfg.valid_labels:
                if label not in labels:
                    labels.append(label)
    return labels


class SymbolTrainingOrchestrator:
    def __init__(
        self,
        config: TrainingConfig,
        model,  # SalmonnModel
        trainer: UnifiedTrainer,
        scheduler: TrainingScheduler,
        train_dataset,
    ):
        self.config = config
        self.model = model
        self.trainer = trainer
        self.scheduler = scheduler
        self.train_dataset = train_dataset

    def run_complete_training(self) -> Dict[str, Any]:
        """(ref symbol_training.py:97-122)"""
        os.makedirs(self.config.output_dir, exist_ok=True)
        with open(os.path.join(self.config.output_dir, "run_config.json"), "w") as f:
            json.dump(
                {"mode": self.config.mode.value,
                 "symbol_mode": self.config.symbol_config.mode.value,
                 "total_cycles": self.config.total_cycles,
                 "dataset_type": self.config.data_config.dataset_type,
                 "run_name": self.config.run_name},
                f, indent=2,
            )

        schedule = self.scheduler.generate_schedule()
        summaries = []
        for step in schedule:
            logger.info(f"=== step {step.step_id}: {step.description} ===")
            summary = self.trainer.train_step(step, self.train_dataset)
            summaries.append(summary)
            if (step.step_id + 1) % self.config.checkpoint_frequency == 0:
                self.trainer.save_checkpoint_with_config(
                    self.config.output_dir, step, summary["final_loss"]
                )
            self._log_cycle_summary(summaries)
        self._log_final_summary(summaries)
        return {"schedule": [s.to_dict() for s in schedule], "summaries": summaries}

    # -- ASCII summary tables (ref :177-495) -----------------------------
    def _format_rows(self, summaries) -> List[str]:
        rows = []
        for s in summaries:
            for e in s["epochs"]:
                val = e.get("val") or {}
                val_str = " ".join(f"{k}={v}" for k, v in val.items()) or "-"
                rows.append(
                    f"| {s['step_id']:>4} | {s['phase']:<6} | {s['cycle']:>5} "
                    f"| {e['epoch']:>5} | {e['loss']:>8.4f} | {val_str}"
                )
        return rows

    def _log_cycle_summary(self, summaries):
        header = "| step | phase  | cycle | epoch |     loss | validation"
        logger.info("\n".join(["", "=" * 80, header, "-" * 80]
                              + self._format_rows(summaries[-1:]) + ["=" * 80]))

    def _log_final_summary(self, summaries):
        header = "| step | phase  | cycle | epoch |     loss | validation"
        logger.info("\n".join(["", "FINAL TRAINING SUMMARY", "=" * 80, header,
                               "-" * 80] + self._format_rows(summaries) + ["=" * 80]))


def build_training_world(config: TrainingConfig, seed: int = 0, device="cuda"):
    """Wire everything from a TrainingConfig (ref orchestrator_training.py:213-300)
    on ``device``."""
    model = create_model(config.model_type, seed=seed, device=device,
                         trainable_dtype=torch.float32)

    train_types = parse_dataset_types(config.data_config.dataset_type)
    val_types = parse_dataset_types(config.data_config.val_dataset_type)

    labels = extract_dataset_labels(val_types or train_types)
    symbol_manager = SymbolManager(
        labels,
        model.tokenizer,
        dynamic_per_epoch=config.symbol_config.mode
        in (SymbolMode.DYNAMIC_PER_EPOCH, SymbolMode.DYNAMIC_PER_CYCLE),
        seed=config.symbol_config.seed,
    )

    n_slots = (
        config.data_config.num_examples + 1
        if config.data_config.fewshot_mode == "speech"
        else 1
    )
    if any(dt.value == "sqa" for dt in set(train_types) | set(val_types)):
        # SQA carries question+document audio per item (ref sqa_config dual
        # audio): 2 slots each for the main item and any speech exemplars
        k = (config.data_config.num_examples
             if config.data_config.fewshot_mode == "speech" else 0)
        n_slots = max(n_slots, 2 * k + 2)
    pack_cfg = PackConfig(
        seq_len=2048, text_len=1024, max_slots=n_slots,
        audio_tokens_per_slot=model.cfg.audio_tokens_per_slot,
    )

    common = dict(
        input_mode=config.data_config.input_mode,
        fewshot_mode=config.data_config.fewshot_mode,
        num_examples=config.data_config.num_examples,
        synthetic=config.data_config.synthetic,
        seed=seed,
    )
    train_ds = create_dataset(
        train_types if len(train_types) > 1 else train_types[0],
        split=DatasetSplit.TRAIN, is_training=True,
        max_samples=config.data_config.max_samples, **common,
    )
    val_datasets = {
        dt: create_dataset(dt, split=DatasetSplit.VAL, is_training=False,
                           max_samples=config.data_config.val_max_samples, **common)
        for dt in val_types
    }

    mlp_params = init_mlp_adapter(
        torch.Generator(device=model.engine.device).manual_seed(seed + 1),
        model.cfg.llm.dim, config.mlp_config.hidden_dim, device=model.engine.device,
    )
    validator = ValidationManager(
        model, symbol_manager, val_datasets, pack_cfg,
        val_max_samples=config.data_config.val_max_samples,
        val_batch_size=config.data_config.val_batch_size or 1,
    )
    trainer = UnifiedTrainer(config, model, mlp_params, symbol_manager, pack_cfg,
                             validator=validator)
    scheduler = TrainingScheduler(config)
    orchestrator = SymbolTrainingOrchestrator(config, model, trainer, scheduler, train_ds)
    return orchestrator


class InferenceOrchestrator:
    """Checkpoint-restoring inference twin (ref orchestrator_inference.py:35-411)."""

    def __init__(self, checkpoint_path: str, config: Optional[TrainingConfig] = None,
                 seed: int = 0, device="cuda"):
        state = load_checkpoint(checkpoint_path)
        meta = state.get("meta", {}).get("metadata", {})
        tc = meta.get("training_config", {})
        if config is None:
            config = TrainingConfig()
            config.model_type = tc.get("model_type", "salmonn-tiny")
            config.data_config.dataset_type = tc.get("dataset_type", "voxceleb")
        self.config = config
        self.config.inference_mode = True

        self.orchestrator = build_training_world(config, seed=seed, device=device)
        trainer = self.orchestrator.trainer
        # restore trainable subtrees (LoRA in the dtype the model holds it
        # in, the adapter f32) + symbol mappings
        trainable = state["trainable"]
        dev = trainer.model.engine.device
        if "lora" in trainable:
            lora = params_from_numpy(trainable["lora"], dev,
                                     _float_dtype(trainer.model.params["lora"]))
            trainer.model.params = {**trainer.model.params, "lora": lora}
            trainer.model.engine.params = trainer.model.params
        if "mlp_adapter" in trainable:
            trainer.mlp_params = params_from_numpy(trainable["mlp_adapter"], dev, torch.float32)
        mappings = meta.get("symbol_mappings")
        if mappings:
            trainer.symbol_manager.fixed_mappings = dict(mappings)
        self.validator = trainer.validator

    def run(self, epoch: int = 0) -> Dict[str, Any]:
        results = self.validator.run_comprehensive_validation(
            epoch=epoch, inference_mode=True
        )
        out_dir = self.config.output_dir
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{self.config.run_name}_inference_results.json")
        with open(path, "w") as f:
            json.dump(to_json_compatible(results), f, indent=2)
        logger.info(f"Saved inference results to {path}")
        return results
