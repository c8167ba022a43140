"""Symbol-adapter configuration tree.

A copy of ``icl_speech_text_llm_tpu/symbol_adapter/configs.py`` (the port
imports nothing of the JAX package), with ``--device`` (default ``cuda``)
in place of ``--platform``. Parity with the reference dataclass config system
(ref: models/symbolAdapter/configs/training_configs.py:13-457): TrainingMode /
SymbolMode enums, MLP/LoRA/Symbol/Data sub-configs, validation + derived
values, argparse bridge with the reference flag names.
"""

from __future__ import annotations

import argparse
import logging
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class TrainingMode(Enum):
    LORA_FIRST = "lora_first"
    MLP_FIRST = "mlp_first"
    JOINT_TRAINING = "joint_training"
    BYPASS_MLP_SYM = "bypass_mlp_sym"
    BYPASS_MLP_ORG = "bypass_mlp_org"
    LORA_MLP_JOINT = "lora_mlp_joint"


class SymbolMode(Enum):
    FIXED = "fixed"
    DYNAMIC_PER_EPOCH = "dynamic_per_epoch"
    DYNAMIC_PER_CYCLE = "dynamic_per_cycle"
    NO_SYMBOLS = "no_symbols"


@dataclass
class MLPConfig:
    use_input_mlp: bool = True
    use_output_mlp: bool = False
    hidden_dim: int = 8
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    dropout: float = 0.1
    epochs: int = 3
    initial_epochs: int = 1
    gradient_accumulation_steps: int = 8
    max_grad_norm: float = 1.0
    scheduler: str = "linear"
    warmup_steps: int = 100
    temperature: float = 0.1  # soft-quantization softmax temperature


@dataclass
class LoRAConfig:
    rank: int = 8
    alpha: int = 32
    dropout: float = 0.1
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    epochs: int = 1
    final_epochs: int = 1
    initial_epochs: int = 1
    gradient_accumulation_steps: int = 8
    max_grad_norm: float = 1.0
    scheduler: str = "cosine"
    warmup_per_epoch: bool = True  # per-epoch warmup-restart (ref :83-86)
    warmup_steps_per_epoch: int = 300
    warmup_ratio: float = 0.0
    warmup_steps: int = 100


@dataclass
class SymbolConfig:
    mode: SymbolMode = SymbolMode.FIXED
    symbol_type: str = "two_token"
    regenerate_frequency: int = 1
    seed: Optional[int] = None


@dataclass
class DataConfig:
    dataset_type: str = "voxceleb"
    batch_size: int = 1
    max_samples: int = 10
    split: str = "test"
    val_batch_size: Optional[int] = 1
    val_max_samples: int = 200
    val_frequency: int = 1
    val_dataset_type: str = "voxceleb-hvb-meld_emotion-voxpopuli"
    input_mode: str = "speech_only"
    fewshot_mode: str = "text"
    num_examples: int = 5
    synthetic: bool = False


@dataclass
class TrainingConfig:
    mode: TrainingMode = TrainingMode.LORA_FIRST
    model_type: str = "salmonn"
    mlp_config: MLPConfig = field(default_factory=MLPConfig)
    lora_config: LoRAConfig = field(default_factory=LoRAConfig)
    symbol_config: SymbolConfig = field(default_factory=SymbolConfig)
    data_config: DataConfig = field(default_factory=DataConfig)
    total_cycles: int = 2
    output_dir: str = "results/symbol_training"
    run_name: str = "symbol_training_run"
    checkpoint_frequency: int = 1
    log_frequency: int = 1
    inference_mode: bool = False
    only_original: bool = False
    scheduler: str = "cosine"
    warmup_steps: int = 100

    def __post_init__(self):
        self._validate()
        self._set_derived()

    def _validate(self):
        """(ref :160-178)"""
        if self.mode == TrainingMode.BYPASS_MLP_SYM:
            if self.symbol_config.mode == SymbolMode.NO_SYMBOLS:
                raise ValueError("BYPASS_MLP_SYM mode requires symbol replacement")
        if self.mode == TrainingMode.BYPASS_MLP_ORG:
            if self.symbol_config.mode != SymbolMode.NO_SYMBOLS:
                logger.warning("BYPASS_MLP_ORG mode typically doesn't use symbols")
        if self.data_config.batch_size <= 0:
            raise ValueError("Batch size must be positive")

    def _set_derived(self):
        """(ref :180-190)"""
        if self.data_config.val_batch_size is None:
            self.data_config.val_batch_size = self.data_config.batch_size
        if (
            self.mode == TrainingMode.BYPASS_MLP_SYM
            and self.symbol_config.mode == SymbolMode.FIXED
        ):
            logger.info("Setting symbol mode to DYNAMIC_PER_EPOCH for BYPASS_MLP_SYM")
            self.symbol_config.mode = SymbolMode.DYNAMIC_PER_EPOCH

    def get_schedule_info(self) -> Dict[str, Any]:
        """(ref :192-214)"""
        if self.mode in (TrainingMode.LORA_FIRST, TrainingMode.MLP_FIRST):
            total_steps = 1 + self.total_cycles * 2 + 1
        elif self.mode in (
            TrainingMode.JOINT_TRAINING,
            TrainingMode.BYPASS_MLP_SYM,
            TrainingMode.BYPASS_MLP_ORG,
        ):
            total_steps = self.total_cycles
        else:  # LORA_MLP_JOINT
            total_steps = 3
        return {"mode": self.mode.value, "total_steps": total_steps,
                "total_cycles": self.total_cycles}

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "TrainingConfig":
        """Bridge from the reference CLI flags (ref :276-347)."""
        cfg = cls(
            mode=TrainingMode(args.training_mode),
            model_type=getattr(args, "model_type", "salmonn"),
            total_cycles=args.total_cycles,
            output_dir=args.output_dir,
            run_name=args.run_name,
            only_original=getattr(args, "only_original", False),
        )
        cfg.mlp_config.epochs = args.mlp_epochs
        cfg.mlp_config.learning_rate = args.mlp_lr
        cfg.mlp_config.hidden_dim = args.mlp_hidden_dim
        cfg.lora_config.epochs = args.lora_epochs
        cfg.lora_config.learning_rate = args.lora_lr
        cfg.symbol_config.mode = SymbolMode(args.symbol_mode)
        cfg.data_config.dataset_type = args.dataset_type
        cfg.data_config.batch_size = args.batch_size
        cfg.data_config.max_samples = args.max_samples
        cfg.data_config.val_max_samples = args.val_max_samples
        cfg.data_config.val_dataset_type = getattr(
            args, "val_dataset_type", cfg.data_config.val_dataset_type
        )
        cfg.data_config.synthetic = getattr(args, "synthetic", False)
        cfg.data_config.num_examples = getattr(args, "num_examples", 5)
        cfg.data_config.fewshot_mode = getattr(args, "fewshot_mode", "text")
        cfg.data_config.input_mode = getattr(args, "input_mode", "speech_only")
        return cfg


def parse_training_args(argv=None) -> argparse.Namespace:
    """Reference back-compat argparse (ref :411-457)."""
    p = argparse.ArgumentParser(description="Symbol adapter training")
    p.add_argument("--training_mode", type=str, default="lora_first",
                   choices=[m.value for m in TrainingMode])
    p.add_argument("--symbol_mode", type=str, default="fixed",
                   choices=[m.value for m in SymbolMode])
    p.add_argument("--model_type", type=str, default="salmonn-tiny")
    p.add_argument("--dataset_type", type=str, default="voxceleb")
    p.add_argument("--val_dataset_type", type=str, default="voxceleb")
    p.add_argument("--total_cycles", type=int, default=2)
    p.add_argument("--mlp_epochs", type=int, default=3)
    p.add_argument("--lora_epochs", type=int, default=1)
    p.add_argument("--mlp_lr", type=float, default=1e-4)
    p.add_argument("--lora_lr", type=float, default=1e-5)
    p.add_argument("--mlp_hidden_dim", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--max_samples", type=int, default=10)
    p.add_argument("--val_max_samples", type=int, default=200)
    p.add_argument("--num_examples", type=int, default=5)
    p.add_argument("--fewshot_mode", type=str, default="text")
    p.add_argument("--input_mode", type=str, default="speech_only")
    p.add_argument("--output_dir", type=str, default="results/symbol_training")
    p.add_argument("--run_name", type=str, default="symbol_training_run")
    p.add_argument("--only_original", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: 'cuda' (kernels) or 'cpu' (plain PyTorch versions)")
    return p.parse_args(argv)
