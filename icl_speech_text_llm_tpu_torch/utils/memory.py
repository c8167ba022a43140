"""Memory utilities: device stats and the batch-size search.

Counterpart of ``icl_speech_text_llm_tpu/utils/memory.py`` (ref:
utils/performance_utils.py:180-306, 452-584; utils/training_utils.py:103-137):

- ``get_device_memory_stats`` / ``log_device_memory_usage``: the same keys,
  from ``torch.cuda.memory_stats`` and ``mem_get_info``;
- ``tile_batch``: a batch of one tiled to a candidate size, as JAX's;
- ``BatchSizeOptimizer``: JAX's doubling-then-bisect search, the same sizes
  probed in the same order and the same pick. JAX asks its compiler how
  much memory a size needs; the port has no compiler to ask, so it
  measures: ``peak_bytes`` runs the probe once at the size and reads the
  peak of ``torch.cuda.max_memory_allocated`` (the weights and every
  other live tensor included, as the compiled program's arguments are);
  an out-of-memory error counts as "does not fit". A probe that runs must
  change no state: the CLIs probe generation (inference mode) and the
  train step's forward and backward without its optimizer update. Under a
  process group of several ranks, each rank measures its own probe and
  ``fits(bs)`` is agreed over every rank (an all-reduce of the flags, the
  least wins), so every rank walks the same search and picks the same size.
"""

from __future__ import annotations

import gc
import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def get_device_memory_stats(device="cuda") -> Dict[str, float]:
    """The card's memory in GiB: in use, peak in use (since the last reset)
    and its total; 0s for a CPU device, which keeps no such counters."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"bytes_in_use_gib": 0.0, "peak_bytes_in_use_gib": 0.0, "bytes_limit_gib": 0.0}
    stats = torch.cuda.memory_stats(device)
    gib = 1024**3
    return {
        "bytes_in_use_gib": stats.get("allocated_bytes.all.current", 0) / gib,
        "peak_bytes_in_use_gib": stats.get("allocated_bytes.all.peak", 0) / gib,
        "bytes_limit_gib": torch.cuda.mem_get_info(device)[1] / gib,
    }


def log_device_memory_usage(prefix: str = "") -> None:
    """(ref: utils/training_utils.py:120-137)"""
    for i in range(torch.cuda.device_count()):
        s = get_device_memory_stats(torch.device("cuda", i))
        logger.info(
            f"{prefix}cuda:{i}: {s['bytes_in_use_gib']:.2f} GiB in use "
            f"(peak {s['peak_bytes_in_use_gib']:.2f}, limit {s['bytes_limit_gib']:.2f})"
        )


def peak_bytes(fn: Callable, make_args: Callable[[], tuple], device="cuda") -> Optional[int]:
    """Run ``fn(*make_args())`` once on the card and return the peak bytes
    allocated meanwhile (everything live at the start included), or None
    when it runs out of memory. Unreachable tensors are collected first, so
    that garbage an earlier caller left is not counted; every reference the
    probe held is dropped and the allocator's cache emptied before
    returning, so that the size picked afterwards can run."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"peak_bytes measures a CUDA device's allocator, not {device}")
    gc.collect()
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    oom = False
    try:
        out = fn(*make_args())
        torch.cuda.synchronize(device)
        del out
    except torch.cuda.OutOfMemoryError:
        oom = True  # the traceback and its frames go when this handler ends
    peak = torch.cuda.max_memory_allocated(device)
    gc.collect()
    torch.cuda.empty_cache()
    return None if oom else peak


def tile_batch(batch, batch_size: int):
    """Tile a batch-of-1 dict of arrays to ``batch_size`` along axis 0.

    Shape probe only — values repeat; used by the CLIs' ``--auto_batch`` to
    run the real step/generate at candidate batch sizes without collating
    more data."""

    def _tile(x):
        if isinstance(x, dict):
            return {k: _tile(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(_tile(v) for v in x)
        if hasattr(x, "ndim") and x.ndim >= 1:
            return np.repeat(np.asarray(x), batch_size, axis=0)
        return x

    return _tile(batch)


class BatchSizeOptimizer:
    """Find the largest batch size whose probe fits the memory budget.

    ``make_args(batch_size) -> tuple`` builds the probe's arguments; the
    search is a doubling probe + binary refinement (ref:
    performance_utils.py:534-584). ``measure(batch_size) -> bytes | None``
    defaults to ``peak_bytes`` of ``fn`` on ``device``; None means "does not
    fit". The budget defaults to 0.9 × the card's memory (8 GiB where the
    device reports none), as JAX's.
    """

    def __init__(
        self,
        fn: Callable,
        make_args: Callable[[int], tuple],
        memory_budget_bytes: Optional[int] = None,
        max_batch: int = 512,
        measure: Optional[Callable[[int], Optional[int]]] = None,
        device="cuda",
    ):
        self.fn = fn
        self.make_args = make_args
        self.max_batch = max_batch
        self.device = torch.device(device)
        self.measure = measure or self._peak_bytes
        if memory_budget_bytes is None:
            stats = get_device_memory_stats(self.device)
            limit = stats["bytes_limit_gib"] * 1024**3
            memory_budget_bytes = int(limit * 0.9) if limit else 8 * 1024**3
        self.budget = memory_budget_bytes

    def _peak_bytes(self, batch_size: int) -> Optional[int]:
        return peak_bytes(self.fn, lambda: self.make_args(batch_size), self.device)

    def _fits(self, batch_size: int) -> bool:
        need = self.measure(batch_size)
        if need is None:
            logger.info(f"batch {batch_size}: out of memory → OOM")
            return self._agreed(False)
        fits = need <= self.budget
        logger.info(
            f"batch {batch_size}: {need/2**30:.2f} GiB needed, "
            f"budget {self.budget/2**30:.2f} → {'fits' if fits else 'OOM'}"
        )
        return self._agreed(fits)

    def _agreed(self, fits: bool) -> bool:
        """``fits`` on every rank of the process group (one all-reduce)."""
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return fits
        from ..parallel import collectives
        from ..parallel.multihost import _collective_device

        flag = torch.tensor([int(fits)], dtype=torch.int32, device=_collective_device())
        return bool(collectives.all_reduce(flag, None, op=dist.ReduceOp.MIN)[0])

    def find_optimal_batch_size(self, start: int = 1) -> int:
        """(ref: performance_utils.py:534-584)"""
        if not self._fits(start):
            return 0
        hi = start
        while hi < self.max_batch:
            nxt = hi * 2
            if nxt > self.max_batch or not self._fits(nxt):
                break
            hi = nxt
        # binary refine between hi and 2*hi
        left, right = hi, min(hi * 2, self.max_batch)
        while left + 1 < right:
            mid = (left + right) // 2
            if self._fits(mid):
                left = mid
            else:
                right = mid
        return left
