"""Task metrics for every task, in numpy and the standard library.

Counterpart of ``icl_speech_text_llm_tpu/evaluation/metrics.py``.
``evaluate_predictions`` routes as the JAX package does: single-label
classification (voxceleb sentiment, MELD emotion and their greek/swap
variants), multi-label classification (HVB dialog acts; VoxPopuli entity
types with an extra ``none`` class), typed timestamp spans (VoxPopuli-NEL)
and spoken QA (exact match, token F1, smoothed BLEU); any other type scores
``{"accuracy": 0.0}``. It never raises: an error inside a metric becomes
``{"error": str(e), "accuracy": 0.0}``, and an empty batch after the
ground-truth filter raises sklearn's own message first, so the dict is the
JAX package's.

The machine with the card has no pandas, sklearn or nltk, so what they
compute there is written out here: sklearn's ``f1_score``,
``precision_score``, ``recall_score``, ``confusion_matrix`` and
``accuracy_score`` (``zero_division=0``; multi-label with ``average`` of
``macro``, ``micro``, ``weighted`` or ``None``) and nltk's ``sentence_bleu``
with ``SmoothingFunction().method1``.
"""

from __future__ import annotations

import logging
import math
import re
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..registry import DatasetType, get_dataset_config, get_swap_config
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
_HVB_ROUTES = {DatasetType.HVB, DatasetType.HVB_SWAP, DatasetType.HVB_GREEK}
_VOXPOPULI_ROUTES = {DatasetType.VOXPOPULI, DatasetType.VOXPOPULI_SWAP,
                     DatasetType.VOXPOPULI_GREEK}

#: sklearn's message for a metric of no samples (``check_consistent_length``)
EMPTY_INPUT_MESSAGE = ("Found empty input array (e.g., `y_true` or `y_pred`) while a minimum "
                       "of 1 sample is required.")


def evaluate_predictions(predictions: List[Dict[str, Any]],
                         dataset_type: DatasetType) -> Dict[str, Any]:
    """Route a list of {true_label, predicted_label, text} dicts to the task
    metric (ref: utils/evaluation_utils.py:16-104)."""
    if not predictions:
        logger.warning("Empty predictions list provided for evaluation")
        return {"error": "Empty predictions list", "accuracy": 0.0}
    try:
        config = (get_swap_config(dataset_type) if dataset_type in _SWAP_TYPES
                  else get_dataset_config(dataset_type))
        if not config:
            return {"error": "Invalid dataset type"}
        gt = [p.get("true_label", "") for p in predictions]
        pd_ = [clean_prediction(p.get("predicted_label", ""), dataset_type) for p in predictions]
        valid = None
        if config.valid_labels is not None:
            valid = [label.lower() for label in config.valid_labels]

        if dataset_type in _SINGLE_LABEL_ROUTES:
            return evaluate_single_label(gt, pd_, valid)
        if dataset_type in _HVB_ROUTES:
            return evaluate_multi_label(gt, pd_, valid, add_none=False)
        if dataset_type in _VOXPOPULI_ROUTES:
            return evaluate_multi_label(gt, pd_, valid, add_none=True)
        if dataset_type == DatasetType.VOXPOPULI_NEL:
            return evaluate_vp_nel(gt, pd_, valid)
        if dataset_type == DatasetType.SQA:
            return evaluate_sqa(gt, pd_)
        logger.warning(f"Unsupported dataset type for evaluation: {dataset_type}")
        return {"accuracy": 0.0}
    except Exception as e:  # the metric engine must never raise into the run loop
        logger.error(f"Error in evaluate_predictions: {e}")
        return {"error": str(e), "accuracy": 0.0}


# ---------------------------------------------------------------------------
# sklearn's precision / recall / F1, zero_division=0
# ---------------------------------------------------------------------------


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num / den with 0 where den == 0 (sklearn's ``_prf_divide``)."""
    num = np.asarray(num, dtype=np.float64)
    den = np.asarray(den, dtype=np.float64)
    return np.where(den == 0, 0.0, num / np.where(den == 0, 1.0, den))


def _average(values: np.ndarray, weights: Optional[np.ndarray]) -> float:
    """sklearn's ``_nanaverage`` for values without NaN: the plain mean when
    no weights are given or they sum to 0."""
    if values.shape[0] == 0:
        return float("nan")
    if weights is None or float(np.sum(weights)) == 0.0:
        return float(np.mean(values))
    return float(np.average(values, weights=weights))


def precision_recall_f1(tp: np.ndarray, pred: np.ndarray, true: np.ndarray,
                        average: Optional[str]):
    """Precision, recall and F1 from per-class counts of true positives,
    predictions and true labels, as sklearn's
    ``precision_recall_fscore_support(beta=1, zero_division=0)``:
    ``average`` None gives arrays, else floats."""
    if average not in (None, "macro", "micro", "weighted"):
        raise ValueError(f"unsupported average {average!r}")
    if average == "micro":
        tp, pred, true = (np.asarray([np.sum(x)]) for x in (tp, pred, true))
    precision = _divide(tp, pred)
    recall = _divide(tp, true)
    f1 = _divide(2.0 * np.asarray(tp, np.float64),
                 np.asarray(true, np.float64) + np.asarray(pred, np.float64))
    if average is None:
        return precision, recall, f1
    weights = np.asarray(true) if average == "weighted" else None
    return tuple(_average(x, weights) for x in (precision, recall, f1))


def _multilabel_counts(y_true, y_pred):
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_true.shape[0] == 0 or y_pred.shape[0] == 0:
        raise ValueError(EMPTY_INPUT_MESSAGE)
    if y_true.shape != y_pred.shape or y_true.ndim != 2:
        raise ValueError(f"indicator matrices differ: {y_true.shape} vs {y_pred.shape}")
    t, p = y_true != 0, y_pred != 0
    return np.sum(t & p, axis=0), np.sum(p, axis=0), np.sum(t, axis=0)


def multilabel_precision(y_true, y_pred, average: Optional[str] = "macro"):
    """sklearn ``precision_score`` of binary indicator matrices, zero_division=0."""
    return precision_recall_f1(*_multilabel_counts(y_true, y_pred), average)[0]


def multilabel_recall(y_true, y_pred, average: Optional[str] = "macro"):
    """sklearn ``recall_score`` of binary indicator matrices, zero_division=0."""
    return precision_recall_f1(*_multilabel_counts(y_true, y_pred), average)[1]


def multilabel_f1(y_true, y_pred, average: Optional[str] = "macro"):
    """sklearn ``f1_score`` of binary indicator matrices, zero_division=0."""
    return precision_recall_f1(*_multilabel_counts(y_true, y_pred), average)[2]


# ---------------------------------------------------------------------------
# Single-label classification
# ---------------------------------------------------------------------------


def _per_class(gt: np.ndarray, pdv: np.ndarray, labels: Sequence[str]):
    """Per-label precision, recall and F1 of single labels, zero_division=0."""
    tp = np.asarray([np.sum((gt == c) & (pdv == c)) for c in labels])
    pred = np.asarray([np.sum(pdv == c) for c in labels])
    true = np.asarray([np.sum(gt == c) for c in labels])
    return precision_recall_f1(tp, pred, true, None)


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
    if after_gt_filter == 0:
        raise ValueError(EMPTY_INPUT_MESSAGE)

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


# ---------------------------------------------------------------------------
# Multi-label classification
# ---------------------------------------------------------------------------


def _split_labels(value, strip: bool) -> List[str]:
    if isinstance(value, str):
        parts = value.split(",")
        return [p.strip().lower() for p in parts] if strip else [p.lower() for p in parts]
    return [label.lower() for label in value]


def _binary_matrix(rows: Sequence[List[str]], classes: List[str]) -> np.ndarray:
    """Binary indicator matrix; rows with no valid label become all-zero
    (ref: utils/evaluation_utils.py:234-243)."""
    out = np.zeros((len(rows), len(classes)))
    for i, labels in enumerate(rows):
        if any(label in classes for label in labels):
            out[i] = [1 if c in labels else 0 for c in classes]
    return out


def evaluate_multi_label(true_labels: Sequence, pred_labels: Sequence,
                         valid_classes: List[str], add_none: bool) -> Dict[str, Any]:
    """Multi-label classification (HVB dialog acts; VoxPopuli entity types
    with an extra 'none' class) (ref: utils/evaluation_utils.py:213-337).

    The HVB route does NOT strip spaces around commas while the VoxPopuli
    route does, as the JAX package and its reference do."""
    total_samples = len(true_labels)
    classes = (valid_classes + ["none"] if add_none and "none" not in valid_classes
               else list(valid_classes))
    gt_rows = [_split_labels(v, strip=add_none) for v in true_labels]
    pd_rows = [_split_labels(v, strip=add_none) for v in pred_labels]

    keep = [any(label in classes for label in labels) for labels in gt_rows]
    gt_rows = [r for r, k in zip(gt_rows, keep) if k]
    pd_rows = [r for r, k in zip(pd_rows, keep) if k]
    after_gt_filter = len(gt_rows)

    invalid_samples = sum(
        1 for labels in pd_rows if not any(label in classes for label in labels))

    y_true = _binary_matrix(gt_rows, classes)
    y_pred = _binary_matrix(pd_rows, classes)

    exact_match = sum(np.array_equal(t, p) for t, p in zip(y_true, y_pred)) / max(1, len(y_true))
    counts = _multilabel_counts(y_true, y_pred)
    prec, rec, f1 = precision_recall_f1(*counts, None)
    return {
        "exact_match": exact_match,
        "macro_f1": precision_recall_f1(*counts, "macro")[2],
        "micro_f1": precision_recall_f1(*counts, "micro")[2],
        "weighted_f1": precision_recall_f1(*counts, "weighted")[2],
        "class_precision": prec.tolist(),
        "class_recall": rec.tolist(),
        "class_f1": f1.tolist(),
        "support": y_true.sum(axis=0).tolist(),
        "total_samples": total_samples,
        "valid_gt_samples": after_gt_filter,
        "invalid_samples": invalid_samples,
        "valid_classes": valid_classes,
    }


# ---------------------------------------------------------------------------
# Timestamp spans (VoxPopuli-NEL, and the untyped variant)
# ---------------------------------------------------------------------------


def parse_entities(entity_string: str) -> List[Tuple[str, float, float]]:
    """Parse 'TYPE: start end; ...' spans (ref: utils/evaluation_utils.py:339-354)."""
    parsed = []
    if not entity_string or entity_string.strip() == "":
        return parsed
    for entity in entity_string.split(";"):
        if entity.strip():
            try:
                entity_type, times = entity.strip().split(":")
                start, end = map(float, times.strip().split())
                parsed.append((entity_type.strip(), start, end))
            except Exception as e:
                logger.warning(f"Error parsing entity: {entity}, Error: {e}")
    return parsed


def _greedy_span_match(gt_entities: List[Tuple], pred_entities: List[Tuple], tolerance: float,
                       typed: bool) -> int:
    """Count predictions matching an unmatched GT span with overlap ≥ tolerance
    (relative to GT duration) (ref: utils/evaluation_utils.py:384-408)."""
    matched_gt: set = set()
    correct = 0
    for pred in pred_entities:
        p_type, p_start, p_end = pred if typed else (None, *pred)
        best_overlap, best_idx = 0.0, None
        for gt_idx, gt in enumerate(gt_entities):
            if gt_idx in matched_gt:
                continue
            g_type, g_start, g_end = gt if typed else (None, *gt)
            if typed and p_type.upper() != g_type.upper():
                continue
            overlap_start = max(p_start, g_start)
            overlap_end = min(p_end, g_end)
            if overlap_end > overlap_start:
                overlap = (overlap_end - overlap_start) / (g_end - g_start)
                if overlap >= tolerance and overlap > best_overlap:
                    best_overlap, best_idx = overlap, gt_idx
        if best_idx is not None:
            correct += 1
            matched_gt.add(best_idx)
    return correct


def _span_f1(correct: int, n_pred: int, n_gt: int) -> Dict[str, float]:
    precision = correct / max(n_pred, 1)
    recall = correct / max(n_gt, 1)
    return {"precision": precision, "recall": recall,
            "f1": 2 * (precision * recall) / max(precision + recall, 1e-6)}


def _timestamp_metrics(parsed_gt: Dict[int, list], parsed_pred: Dict[int, list],
                       typed: bool) -> Dict[str, Any]:
    """Word-level (tolerance sweep) + frame-level (centisecond) span metrics
    (ref: utils/evaluation_utils.py:368-467,733-830)."""
    word_metrics = {}
    for tolerance in [1.0, 0.9, 0.8, 0.7, 0.6, 0.5]:
        total_correct = total_pred = total_gt = 0
        for idx in parsed_gt:
            gt_entities = parsed_gt[idx]
            pred_entities = parsed_pred.get(idx, [])
            total_gt += len(gt_entities)
            total_pred += len(pred_entities)
            total_correct += _greedy_span_match(gt_entities, pred_entities, tolerance, typed)
        word_metrics[str(tolerance)] = _span_f1(total_correct, total_pred, total_gt)

    total_pred_frames = total_gt_frames = total_correct_frames = 0
    for idx in parsed_gt:
        gt_entities = parsed_gt[idx]
        pred_entities = parsed_pred.get(idx, [])
        for pred in pred_entities:
            p_type, p_start, p_end = pred if typed else (None, *pred)
            total_pred_frames += int((p_end - p_start) * 100)
            for gt in gt_entities:
                g_type, g_start, g_end = gt if typed else (None, *gt)
                if typed and p_type.upper() != g_type.upper():
                    continue
                overlap_start = max(p_start, g_start)
                overlap_end = min(p_end, g_end)
                if overlap_end > overlap_start:
                    total_correct_frames += int((overlap_end - overlap_start) * 100)
        for gt in gt_entities:
            _, g_start, g_end = gt if typed else (None, *gt)
            total_gt_frames += int((g_end - g_start) * 100)

    return {
        "word_metrics": word_metrics,
        "frame_metrics": _span_f1(total_correct_frames, total_pred_frames, total_gt_frames),
        "total_frames": {"gt": total_gt_frames, "pred": total_pred_frames,
                         "correct": total_correct_frames},
    }


def evaluate_vp_nel(true_labels: Sequence[str], pred_labels: Sequence[str],
                    valid_classes: Optional[List[str]] = None) -> Dict[str, Any]:
    """VP-NEL: typed timestamp spans (ref: utils/evaluation_utils.py:356-467)."""
    parsed_gt = {i: parse_entities(g.lower()) for i, g in enumerate(true_labels)}
    parsed_pred = {i: parse_entities(p.lower()) for i, p in enumerate(pred_labels)}
    out = _timestamp_metrics(parsed_gt, parsed_pred, typed=True)
    out.update(
        total_samples=len(true_labels),
        total_gt_entities=sum(len(v) for v in parsed_gt.values()),
        total_pred_entities=sum(len(v) for v in parsed_pred.values()),
    )
    return out


def _parse_timestamps(time_string: str) -> List[Tuple[float, float]]:
    if not time_string or time_string.strip() == "":
        return []
    try:
        start, end = map(float, time_string.strip().split())
        return [(start, end)]
    except Exception as e:
        logger.warning(f"Error parsing timestamps: {time_string}, Error: {e}")
        return []


def evaluate_sqq(true_labels: Sequence[str], pred_labels: Sequence[str],
                 valid_classes: Optional[List[str]] = None) -> Dict[str, Any]:
    """Untyped 'start end' timestamp variant (ref: utils/evaluation_utils.py:714-830)."""
    parsed_gt = {i: _parse_timestamps(g) for i, g in enumerate(true_labels)}
    parsed_pred = {i: _parse_timestamps(p) for i, p in enumerate(pred_labels)}
    out = _timestamp_metrics(parsed_gt, parsed_pred, typed=False)
    out.update(
        total_samples=len(true_labels),
        total_gt_segments=sum(len(v) for v in parsed_gt.values()),
        total_pred_segments=sum(len(v) for v in parsed_pred.values()),
    )
    return out


# ---------------------------------------------------------------------------
# Spoken QA
# ---------------------------------------------------------------------------


def normalize_answer(text) -> str:
    """Lowercase, strip punctuation/extra spaces (ref: utils/evaluation_utils.py:855-862)."""
    if text is None:
        return ""
    text = str(text).lower()
    text = re.sub(r"[^\w\s]", " ", text)
    return re.sub(r"\s+", " ", text).strip()


def _ngram_counts(tokens: Sequence[str], n: int) -> Counter:
    if len(tokens) < n:
        return Counter()
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def sentence_bleu(reference: Sequence[str], hypothesis: Sequence[str], max_n: int = 4,
                  epsilon: float = 0.1):
    """nltk's ``sentence_bleu([reference], hypothesis,
    smoothing_function=SmoothingFunction().method1)`` with uniform weights
    over ``max_n`` orders: clipped n-gram counts over a denominator of at
    least 1, ``epsilon`` in place of a zero numerator, the brevity penalty
    against the one reference. No unigram in common gives the integer 0, as
    nltk does; a hypothesis shorter than ``max_n`` still takes every order
    (its missing orders count 0 / 1, smoothed to ``epsilon``)."""
    precisions = []
    for n in range(1, max_n + 1):
        counts = _ngram_counts(hypothesis, n)
        ref_counts = _ngram_counts(reference, n)
        numerator = sum(min(c, ref_counts[g]) for g, c in counts.items())
        denominator = max(1, sum(counts.values()))
        if n == 1 and numerator == 0:
            return 0
        precisions.append((numerator + epsilon) / denominator if numerator == 0
                          else numerator / denominator)
    hyp_len, ref_len = len(hypothesis), len(reference)
    bp = 1 if hyp_len > ref_len else math.exp(1 - ref_len / hyp_len)
    weight = 1.0 / max_n
    return bp * math.exp(math.fsum(weight * math.log(p) for p in precisions if p > 0))


def evaluate_sqa(true_labels: Sequence, pred_labels: Sequence,
                 valid_classes: Optional[List[str]] = None) -> Dict[str, Any]:
    """QA: normalized exact match, token F1, smoothed BLEU
    (ref: utils/evaluation_utils.py:832-957)."""
    total_samples = len(true_labels)
    exact_matches = 0
    f1_scores: List[float] = []
    bleu_scores: List[float] = []
    for gt, pred in zip(true_labels, pred_labels):
        gt, pred = gt or "", pred or ""
        gt_norm, pred_norm = normalize_answer(gt), normalize_answer(pred)
        exact_matches += int(gt_norm == pred_norm)
        gt_tokens = gt_norm.split() if gt_norm else []
        pred_tokens = pred_norm.split() if pred_norm else []
        if not gt_tokens and not pred_tokens:
            f1 = 1.0
        elif not gt_tokens or not pred_tokens:
            f1 = 0.0
        else:
            common = Counter(gt_tokens) & Counter(pred_tokens)
            num_common = sum(common.values())
            precision = num_common / max(len(pred_tokens), 1)
            recall = num_common / max(len(gt_tokens), 1)
            f1 = 2 * (precision * recall) / max(precision + recall, 1e-6)
        f1_scores.append(f1)
        if gt_tokens:
            bleu = sentence_bleu(gt_tokens, pred_tokens)
        else:
            bleu = 0.0 if pred_tokens else 1.0
        bleu_scores.append(bleu)
    return {
        "exact_match": exact_matches / max(total_samples, 1),
        "f1_score": sum(f1_scores) / max(len(f1_scores), 1),
        "bleu_score": sum(bleu_scores) / max(len(bleu_scores), 1),
        "total_samples": total_samples,
        "samples_evaluated": len(f1_scores),
        "sample_metrics": {
            "exact_match": [1 if f == 1.0 else 0 for f in f1_scores],
            "f1_scores": f1_scores,
            "bleu_scores": bleu_scores,
        },
    }

