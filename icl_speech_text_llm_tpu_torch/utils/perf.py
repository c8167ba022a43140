"""Performance tracking, spans, device intervals and the profiler switch.

Counterpart of ``icl_speech_text_llm_tpu/utils/perf.py`` (ref:
utils/performance_utils.py:15-177, 336-375):

- ``PerformanceTracker``, copied: step time, examples/s, tokens/s and the
  rolling loss, on the host clock. The symbol trainer reads its summary
  after every schedule step; the loss it is given is a Python float, so
  each update follows the device's step.
- ``span(name)``: a range named ``port/<name>`` on the profiler's
  timeline, at a layer edge of the port (the collate, the engine's copies,
  encode, prefill and decode loop, the train step's phases), where a
  ``torch.profiler`` is recording on this thread. With no profiler on, it
  is one shared null context and records nothing.
- ``StepEvents`` / ``device_events``: device intervals between CUDA
  events, read once the host holds the results, so timing adds no
  synchronisation.
- ``torch_profile(outdir)``: a ``torch.profiler`` trace (CPU activity, and
  CUDA activity where a card is present) written as a Chrome trace into
  ``outdir``; the JAX package's ``jax_profile``.
- ``log_system_info``: host memory, the torch and CUDA versions and the
  cards' names, where the JAX package logs its backend.

``enable_compilation_cache`` (the XLA cache, TPU only) has no counterpart;
nor have ``timer`` and ``time_function``, whose host clock times the
enqueue of CUDA work, not the work.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import deque
from typing import Dict, List, Optional

import torch

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


SPAN_PREFIX = "port/"
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``port/<name>`` on the profiler's timeline around the block, where a
    ``torch.profiler`` records this thread; else a shared null context.

    The range is of the function scope, drawn on the host's timeline only:
    a ``record_function`` range (user scope) is drawn a second time over
    the kernels it launched, as a CUDA-device event, which a reader of the
    trace would count as device work."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)


class StepEvents:
    """CUDA events marked on the current stream; ``millis()`` gives the ms
    between each mark and the next. Read once the host holds what the
    marked work made, so timing adds no synchronisation."""

    def __init__(self):
        self.events: List[torch.cuda.Event] = []

    def mark(self) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)

    def millis(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]


def device_events(device) -> Optional[StepEvents]:
    """A ``StepEvents`` for work on ``device`` where it is a CUDA device,
    else None: the CPU's work is timed by the host's clock."""
    return StepEvents() if torch.device(device).type == "cuda" else None


@contextlib.contextmanager
def torch_profile(outdir: Optional[str] = None):
    """Trace the block with ``torch.profiler`` and write a Chrome trace
    (``trace_<pid>_<ns>.json``) into ``outdir``; yields the profiler, or
    None and traces nothing when ``outdir`` is empty. Records CPU activity,
    and CUDA activity (the kernels by name) where a card is present."""
    if not outdir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info(f"profiler trace written to {path}")


def log_system_info():
    """(ref: utils/performance_utils.py:336-375)"""
    try:
        import psutil

        vm = psutil.virtual_memory()
        logger.info(f"Host memory: {vm.total/2**30:.1f} GiB total, {vm.percent}% used")
    except ImportError:
        pass
    cards = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    logger.info(f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
                f"devices: {cards or 'no CUDA device'}")
