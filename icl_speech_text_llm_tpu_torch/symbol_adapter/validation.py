"""Multi-mode validation for symbol training.

Counterpart of ``icl_speech_text_llm_tpu/symbol_adapter/validation.py``,
framework-free apart from the model it drives: the port's
``evaluate_predictions`` (numpy) scores, ``model.generate_output`` (the
static engine: K1 prefill and K4 appends on the card) generates. The
``no_mlp_fresh`` mode draws its throwaway symbols from an unseeded
``SymbolManager``, as the reference does. Rebuild of the reference
ValidationManager (ref: models/symbolAdapter/training/validation.py:26-588):
per mode — symbol-replace, generate, convert symbols back, clean, evaluate —
with the reference's headline-metric choice and composite
"ds:score|ds:score" strings.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

from ..data.collate import ICLSample
from ..data.packing import PackConfig
from ..evaluation import clean_prediction, evaluate_predictions
from ..registry import DatasetType
from .symbol_manager import SymbolManager
from .trainer import replace_symbols_in_sample

logger = logging.getLogger(__name__)

#: Validation modes (ref :378-382)
VALIDATION_MODES = ("no_mlp_symbols", "no_mlp_fresh", "no_mlp_original")


def headline_metric(dataset_type: str, metrics: Dict[str, Any]) -> float:
    """Per-dataset headline metric (ref :292-299: voxceleb-family →
    macro_f1_with_invalid; multi-label → macro_f1; else first match)."""
    order = (
        ["macro_f1_with_invalid", "macro_f1", "f1_score", "accuracy"]
        if dataset_type.startswith(("voxceleb", "meld"))
        else ["macro_f1", "macro_f1_with_invalid", "f1_score", "accuracy"]
    )
    for key in order:
        if key in metrics:
            return float(metrics[key])
    return 0.0


def create_composite_metric(per_dataset: Dict[str, float]) -> str:
    """'ds:score|ds:score' composite (ref :557-566)."""
    return "|".join(f"{ds}:{score:.4f}" for ds, score in per_dataset.items())


def parse_composite_metric(composite: str) -> Dict[str, float]:
    """(ref :568-576)"""
    out = {}
    for part in composite.split("|"):
        if ":" in part:
            ds, score = part.rsplit(":", 1)
            out[ds] = float(score)
    return out


class ValidationManager:
    def __init__(
        self,
        model,  # SalmonnModel
        symbol_manager: SymbolManager,
        val_datasets: Dict[DatasetType, Any],
        pack_cfg: PackConfig,
        val_max_samples: int = 200,
        val_batch_size: int = 2,
        modes: tuple = VALIDATION_MODES,
        skip_val_only_in_fixed: bool = False,
    ):
        self.model = model
        self.symbol_manager = symbol_manager
        self.val_datasets = val_datasets
        self.pack_cfg = pack_cfg
        self.val_max_samples = val_max_samples
        self.val_batch_size = val_batch_size
        self.modes = modes

    # ------------------------------------------------------------------
    def _mode_mappings(self, mode: str, epoch: int) -> Optional[Dict[str, str]]:
        if mode == "no_mlp_symbols":
            return self.symbol_manager.get_symbols_for_epoch(epoch)
        if mode == "no_mlp_fresh":
            # fresh throwaway mapping, does not pollute epoch history
            fresh = SymbolManager(
                self.symbol_manager.original_labels,
                self.symbol_manager.tokenizer,
                dynamic_per_epoch=False,
            )
            return fresh.fixed_mappings
        return None  # original labels

    def _run_mode(
        self, mode: str, epoch: int, collect_predictions: bool = False
    ) -> Dict[str, Any]:
        per_dataset_scores: Dict[str, float] = {}
        detailed: Dict[str, Any] = {}
        predictions_out: List[Dict[str, Any]] = []
        mappings = self._mode_mappings(mode, epoch)

        for dt, dataset in self.val_datasets.items():
            n = min(len(dataset), self.val_max_samples)
            results = []
            bs = self.val_batch_size
            for start in range(0, n, bs):
                samples: List[ICLSample] = [
                    dataset[i] for i in range(start, min(start + bs, n))
                ]
                real = len(samples)
                if mappings:
                    samples = [replace_symbols_in_sample(s, mappings) for s in samples]
                while len(samples) < bs:
                    samples.append(samples[-1])
                preds = self.model.generate_output(samples)[:real]
                for s, pred in zip(samples[:real], preds):
                    if mappings:
                        pred = self.symbol_manager.convert_symbols_back(
                            pred, mappings=mappings
                        )
                        true = self.symbol_manager.convert_symbols_back(
                            s.completion, mappings=mappings
                        )
                    else:
                        true = s.completion
                    row = {
                        "text": s.extras.get("text", ""),
                        "true_label": true,
                        "predicted_label": pred,
                        "cleaned": clean_prediction(pred, dt),
                        "dataset_type": dt.value,
                        "mode": mode,
                    }
                    results.append(row)
                    if collect_predictions:
                        predictions_out.append(row)
            if results:
                metrics = evaluate_predictions(results, dt)
                per_dataset_scores[dt.value] = headline_metric(dt.value, metrics)
                detailed[dt.value] = metrics

        out = {
            "mode": mode,
            "per_dataset": per_dataset_scores,
            "composite": create_composite_metric(per_dataset_scores),
            "detailed": detailed,
        }
        if collect_predictions:
            out["predictions"] = predictions_out
        return out

    # ------------------------------------------------------------------
    def validate_model(self, epoch: int = 0) -> Dict[str, str]:
        """Per-epoch validation: composite string per mode (ref :40-106)."""
        out = {}
        for mode in self.modes:
            res = self._run_mode(mode, epoch)
            out[mode] = res["composite"]
            logger.info(f"validation[{mode}]: {res['composite']}")
        return out

    def run_comprehensive_validation(
        self, epoch: int = 0, inference_mode: bool = False
    ) -> Dict[str, Any]:
        """All modes with detailed metrics (+ tagged predictions in inference
        mode) (ref :342-467)."""
        return {
            mode: self._run_mode(mode, epoch, collect_predictions=inference_mode)
            for mode in self.modes
        }
