"""Result persistence and error analysis, over the port's numpy metrics.

Counterpart of ``icl_speech_text_llm_tpu/evaluation/reporting.py``
(ref: utils/evaluation_utils.py:597-712, reprocess_metrics.py).
"""

from __future__ import annotations

import json
import logging
import os
from collections import Counter
from typing import Any, Dict, List

import numpy as np

from ..registry import DatasetType
from .metrics import evaluate_predictions

logger = logging.getLogger(__name__)

_MULTI_LABEL = {DatasetType.HVB, DatasetType.HVB_SWAP, DatasetType.HVB_GREEK}


def to_json_compatible(obj):
    """Recursively convert numpy scalars/arrays to plain Python types
    (ref: utils/evaluation_utils.py:693-707)."""
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, dict):
        return {k: to_json_compatible(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_json_compatible(i) for i in obj]
    return obj


def save_evaluation_results(metrics: Dict, output_dir: str, filename: str) -> str:
    """Write metrics JSON (ref: utils/evaluation_utils.py:680-712)."""
    os.makedirs(output_dir, exist_ok=True)
    output_path = os.path.join(output_dir, filename)
    with open(output_path, "w") as f:
        json.dump(to_json_compatible(metrics), f, indent=2)
    logger.info(f"Saved evaluation results to {output_path}")
    return output_path


def analyze_errors(
    true_labels: List[Any], pred_labels: List[Any], dataset_type: DatasetType
) -> Dict[str, Any]:
    """Confusion analysis (ref: utils/evaluation_utils.py:597-678): set
    differences per sample for the multi-label HVB tasks, (true → pred) pairs
    for the others; an error inside becomes ``{"error", "num_errors": 0,
    "error_rate": 0.0}``."""
    try:
        if dataset_type in _MULTI_LABEL:
            errors = []
            for i, (true, pred) in enumerate(zip(true_labels, pred_labels)):
                true_set = set(true) if isinstance(true, list) else {true}
                pred_set = set(pred) if isinstance(pred, list) else {pred}
                if true_set != pred_set:
                    errors.append(
                        {
                            "index": i,
                            "true": true,
                            "pred": pred,
                            "missing": list(true_set - pred_set),
                            "extra": list(pred_set - true_set),
                        }
                    )
            missing_counts: Counter = Counter()
            extra_counts: Counter = Counter()
            for error in errors:
                missing_counts.update(error["missing"])
                extra_counts.update(error["extra"])
            return {
                "num_errors": len(errors),
                "error_rate": len(errors) / len(true_labels),
                "common_missing_labels": dict(missing_counts.most_common(5)),
                "common_extra_labels": dict(extra_counts.most_common(5)),
                "example_errors": errors[:5],
            }

        errors = [
            {"index": i, "true": true, "pred": pred}
            for i, (true, pred) in enumerate(zip(true_labels, pred_labels))
            if true != pred
        ]
        confusion_pairs = Counter((e["true"], e["pred"]) for e in errors)
        common_confusions = {
            f"{true} → {pred}": count
            for (true, pred), count in confusion_pairs.most_common(5)
        }
        return {
            "num_errors": len(errors),
            "error_rate": len(errors) / len(true_labels),
            "common_confusions": common_confusions,
            "example_errors": errors[:5],
        }
    except Exception as e:
        logger.error(f"Error in analyze_errors: {e}")
        return {"error": str(e), "num_errors": 0, "error_rate": 0.0}


def reprocess_results(results_path: str, dataset_type: DatasetType) -> Dict[str, Any]:
    """Re-score a saved results JSON offline (ref: reprocess_metrics.py:7-60)."""
    with open(results_path) as f:
        results = json.load(f)
    predictions = results["results"] if isinstance(results, dict) else results
    return evaluate_predictions(predictions, dataset_type)
