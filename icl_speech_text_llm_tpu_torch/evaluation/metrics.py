"""Task metrics for the single-label tasks, in numpy.

Counterpart of the single-label route of
``icl_speech_text_llm_tpu/evaluation/metrics.py`` (``evaluate_predictions``
→ ``evaluate_single_label``: voxceleb sentiment and MELD emotion, with their
greek/swap variants), computing what sklearn's ``f1_score``,
``precision_score``, ``recall_score``, ``confusion_matrix`` and
``accuracy_score`` give there (``zero_division=0``) without pandas or
sklearn, which the machine with the card does not have. Other task types
raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Sequence

import numpy as np

from icl_speech_text_llm_tpu.registry import DatasetType, get_dataset_config, get_swap_config

from .cleaning import clean_prediction

logger = logging.getLogger(__name__)

_SWAP_TYPES = {DatasetType.VOXCELEB_SWAP, DatasetType.HVB_SWAP, DatasetType.VOXPOPULI_SWAP}

_SINGLE_LABEL_ROUTES = {
    DatasetType.VOXCELEB,
    DatasetType.VOXCELEB_SWAP,
    DatasetType.VOXCELEB_GREEK,
    DatasetType.MELD,
    DatasetType.MELD_GREEK,
    DatasetType.MELD_EMOTION,
    DatasetType.MELD_EMOTION_GREEK,
}


def evaluate_predictions(predictions: List[Dict[str, Any]],
                         dataset_type: DatasetType) -> Dict[str, Any]:
    """Score {true_label, predicted_label, text} dicts for a single-label task."""
    if dataset_type not in _SINGLE_LABEL_ROUTES:
        raise NotImplementedError(
            f"the port scores single-label tasks only, not {dataset_type.value}")
    if not predictions:
        logger.warning("Empty predictions list provided for evaluation")
        return {"error": "Empty predictions list", "accuracy": 0.0}
    config = (get_swap_config(dataset_type) if dataset_type in _SWAP_TYPES
              else get_dataset_config(dataset_type))
    if not config:
        return {"error": "Invalid dataset type"}
    gt = [p.get("true_label", "") for p in predictions]
    pd_ = [clean_prediction(p.get("predicted_label", ""), dataset_type) for p in predictions]
    valid = None
    if config.valid_labels is not None:
        valid = [label.lower() for label in config.valid_labels]
    return evaluate_single_label(gt, pd_, valid)


def _per_class(gt: np.ndarray, pdv: np.ndarray, labels: Sequence[str]):
    """Per-label precision, recall and F1 with zero_division=0."""
    prec, rec, f1 = [], [], []
    for c in labels:
        tp = float(np.sum((gt == c) & (pdv == c)))
        fp = float(np.sum((gt != c) & (pdv == c)))
        fn = float(np.sum((gt == c) & (pdv != c)))
        prec.append(tp / (tp + fp) if tp + fp else 0.0)
        rec.append(tp / (tp + fn) if tp + fn else 0.0)
        f1.append(2 * tp / (2 * tp + fp + fn) if tp else 0.0)
    return np.asarray(prec), np.asarray(rec), np.asarray(f1)


def evaluate_single_label(true_labels: Sequence[str], pred_labels: Sequence[str],
                          valid_classes: List[str]) -> Dict[str, Any]:
    """Single-label classification: macro-F1 with an 'invalid' bucket plus
    filtered standard metrics (ref: utils/evaluation_utils.py:106-211)."""
    total_samples = len(true_labels)
    gt = np.asarray([str(g).lower() for g in true_labels], dtype=object)
    pdv = np.asarray([str(p).lower() for p in pred_labels], dtype=object)
    keep = np.isin(gt, valid_classes)
    gt, pdv = gt[keep], pdv[keep]
    after_gt_filter = int(len(gt))

    in_valid = np.isin(pdv, valid_classes)
    pred_with_invalid = np.where(in_valid, pdv, "invalid")
    macro_f1_with_invalid = float(_per_class(gt, pred_with_invalid, valid_classes)[2].mean())
    n_invalid = int((~in_valid).sum())

    gt_f, pd_f = gt[in_valid], pdv[in_valid]
    if len(gt_f) == 0:
        logger.warning("No valid predictions found for evaluation")
        return {
            "macro_f1_filtered": 0.0,
            "macro_f1_with_invalid": 0.0,
            "invalid_predictions": n_invalid,
            "total_samples": total_samples,
            "valid_gt_samples": after_gt_filter,
            "valid_samples": 0,
        }
    index = {c: i for i, c in enumerate(valid_classes)}
    matrix = np.zeros((len(valid_classes), len(valid_classes)), dtype=np.int64)
    for g, p in zip(gt_f, pd_f):
        matrix[index[g], index[p]] += 1
    prec, rec, f1 = _per_class(gt_f, pd_f, valid_classes)
    with np.errstate(divide="ignore", invalid="ignore"):
        class_acc = matrix.diagonal() / matrix.sum(axis=1)
    return {
        "accuracy": float(np.mean(gt_f == pd_f)),
        "macro_f1_filtered": float(f1.mean()),
        "class_accuracy_filtered": class_acc.tolist(),
        "class_precision": prec.tolist(),
        "class_recall": rec.tolist(),
        "class_f1": f1.tolist(),
        "confusion_matrix_filtered": matrix.tolist(),
        "valid_samples": int(len(gt_f)),
        "macro_f1_with_invalid": macro_f1_with_invalid,
        "invalid_predictions": n_invalid,
        "total_samples": total_samples,
        "valid_gt_samples": after_gt_filter,
        "valid_classes": valid_classes,
    }



def to_json_compatible(obj):
    """Recursively convert numpy scalars/arrays to plain Python types."""
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
