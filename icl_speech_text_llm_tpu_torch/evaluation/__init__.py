"""Prediction cleaning, every task's metrics (without pandas, sklearn or
nltk), result persistence and error analysis."""

from .cleaning import clean_prediction
from .metrics import (
    evaluate_multi_label,
    evaluate_predictions,
    evaluate_single_label,
    evaluate_sqa,
    evaluate_sqq,
    evaluate_vp_nel,
)
from .reporting import (
    analyze_errors,
    reprocess_results,
    save_evaluation_results,
    to_json_compatible,
)

__all__ = ["clean_prediction", "evaluate_multi_label", "evaluate_predictions",
           "evaluate_single_label", "evaluate_sqa", "evaluate_sqq", "evaluate_vp_nel",
           "analyze_errors", "save_evaluation_results", "reprocess_results",
           "to_json_compatible"]
