"""Prediction cleaning and single-label metrics, without pandas or sklearn."""

from .cleaning import clean_prediction
from .metrics import evaluate_predictions, evaluate_single_label, to_json_compatible

__all__ = ["clean_prediction", "evaluate_predictions", "evaluate_single_label",
           "to_json_compatible"]
