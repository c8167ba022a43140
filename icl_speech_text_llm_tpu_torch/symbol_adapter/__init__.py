"""Symbol-adapter research subsystem in PyTorch (ref layer L6,
models/symbolAdapter/**): random-symbol label replacement, MLP symbol
discovery, multi-phase schedules, multi-mode validation, orchestrators.
Counterpart of ``icl_speech_text_llm_tpu/symbol_adapter``, with the same
``__all__``."""

from .configs import (
    DataConfig,
    LoRAConfig,
    MLPConfig,
    SymbolConfig,
    SymbolMode,
    TrainingConfig,
    TrainingMode,
    parse_training_args,
)
from .mlp_adapter import (
    collect_discoveries,
    init_mlp_adapter,
    label_token_mask,
    quantize_to_vocab,
    transform_label_embeddings,
)
from .orchestrator import (
    InferenceOrchestrator,
    SymbolTrainingOrchestrator,
    build_training_world,
    extract_dataset_labels,
)
from .schedulers import TrainingScheduler, TrainingStep
from .symbol_manager import SymbolManager
from .trainer import UnifiedTrainer, replace_symbols_in_sample
from .validation import (
    ValidationManager,
    create_composite_metric,
    headline_metric,
    parse_composite_metric,
)

__all__ = [
    "DataConfig", "LoRAConfig", "MLPConfig", "SymbolConfig", "SymbolMode",
    "TrainingConfig", "TrainingMode", "parse_training_args",
    "collect_discoveries", "init_mlp_adapter", "label_token_mask",
    "quantize_to_vocab", "transform_label_embeddings",
    "InferenceOrchestrator", "SymbolTrainingOrchestrator",
    "build_training_world", "extract_dataset_labels",
    "TrainingScheduler", "TrainingStep", "SymbolManager", "UnifiedTrainer",
    "replace_symbols_in_sample", "ValidationManager",
    "create_composite_metric", "headline_metric", "parse_composite_metric",
]
