"""The rolling performance tracker of the symbol trainer.

``PerformanceTracker`` of ``icl_speech_text_llm_tpu/utils/perf.py`` (ref:
utils/performance_utils.py:15-127), copied: step time, examples/s,
tokens/s and the rolling loss, on the host clock. The symbol trainer reads
its summary after every schedule step; the loss it is given is a Python
float, so each update follows the device's step.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class PerformanceTracker:
    """Rolling throughput/latency/loss tracker
    (ref: utils/performance_utils.py:15-127)."""

    def __init__(self, log_interval: int = 10, window: int = 100):
        self.log_interval = log_interval
        self.step_times = deque(maxlen=window)
        self.losses = deque(maxlen=window)
        self.examples = deque(maxlen=window)
        self.tokens = deque(maxlen=window)
        self.total_examples = 0
        self.total_steps = 0
        self._last = None
        self.start_time = time.time()

    def update(self, loss: Optional[float] = None, examples: int = 0, tokens: int = 0):
        now = time.time()
        if self._last is not None:
            self.step_times.append(now - self._last)
        self._last = now
        if loss is not None:
            self.losses.append(float(loss))
        self.examples.append(examples)
        self.tokens.append(tokens)
        self.total_examples += examples
        self.total_steps += 1
        if self.log_interval and self.total_steps % self.log_interval == 0:
            self.log_metrics()

    def get_summary(self) -> Dict[str, float]:
        elapsed = max(time.time() - self.start_time, 1e-9)
        window_time = sum(self.step_times) or 1e-9
        return {
            "steps": self.total_steps,
            "avg_step_time": window_time / max(len(self.step_times), 1),
            "examples_per_sec": sum(self.examples) / window_time if self.step_times else 0.0,
            "tokens_per_sec": sum(self.tokens) / window_time if self.step_times else 0.0,
            "avg_loss": sum(self.losses) / max(len(self.losses), 1),
            "total_examples": self.total_examples,
            "elapsed": elapsed,
        }

    def log_metrics(self):
        s = self.get_summary()
        logger.info(
            f"step {s['steps']}: {s['examples_per_sec']:.2f} ex/s, "
            f"{s['tokens_per_sec']:.0f} tok/s, avg step {s['avg_step_time']*1000:.1f} ms, "
            f"avg loss {s['avg_loss']:.4f}"
        )
