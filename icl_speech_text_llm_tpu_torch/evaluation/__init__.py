"""Prediction cleaning and every task's metrics, without pandas, sklearn or nltk."""

from .cleaning import clean_prediction
from .metrics import (
    evaluate_multi_label,
    evaluate_predictions,
    evaluate_single_label,
    evaluate_sqa,
    evaluate_sqq,
    evaluate_vp_nel,
    to_json_compatible,
)

__all__ = ["clean_prediction", "evaluate_multi_label", "evaluate_predictions",
           "evaluate_single_label", "evaluate_sqa", "evaluate_sqq", "evaluate_vp_nel",
           "to_json_compatible"]
