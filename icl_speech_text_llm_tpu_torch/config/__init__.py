"""Static config parity surface (ref layer L8, config/)."""

from .static_configs import get_inference_config, get_training_config

__all__ = ["get_training_config", "get_inference_config"]
