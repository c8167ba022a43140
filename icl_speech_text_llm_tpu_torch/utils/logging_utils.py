"""Logging setup (ref: utils/training_utils.py:10-27).

A copy of ``icl_speech_text_llm_tpu/utils/logging_utils.py`` (it uses no
framework), so that the port imports nothing of the JAX package; the code
below this docstring is the original's, line for line.
"""

from __future__ import annotations

import logging
import os
from typing import Optional


def setup_logging(
    log_file: Optional[str] = None, level: int = logging.INFO, force: bool = True
) -> logging.Logger:
    """File + console logging with timestamps."""
    handlers: list = [logging.StreamHandler()]
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=level,
        format="%(asctime)s - %(levelname)s - %(message)s",
        handlers=handlers,
        force=force,
    )
    return logging.getLogger()
