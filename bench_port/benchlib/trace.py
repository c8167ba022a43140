"""The traced run's readings, from ``torch.profiler``'s device timeline:
the seconds in which anything ran on the device, each kernel's device
time, the longest idle gaps with the benchmark span the host was in, and
the synchronising CUDA calls (``torch.cuda.set_sync_debug_mode``).

Spans are ``torch.profiler.record_function`` ranges named ``bench/...``
that the drivers put around their calls into the program's layers.
"""

from __future__ import annotations

import contextlib
import warnings
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

SPAN = "bench/"
WINDOW = "window"


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def span(name: str):
    return torch.profiler.record_function(SPAN + name)


def _times(e) -> Tuple[float, float]:
    """(start, end) in seconds of a kineto event."""
    if hasattr(e, "start_ns"):
        s = e.start_ns() * 1e-9
        return s, s + e.duration_ns() * 1e-9
    s = e.start_us() * 1e-6
    return s, s + e.duration_us() * 1e-6


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(prof) -> Dict:
    """→ {"window_s", "busy_s", "kernel_s" {name: s}, "device_ops" [[name,
    s]] (top 10), "idle_gaps" [[span, s]] (top 10)} over the ``WINDOW``
    span."""
    device, spans = [], []
    kernel_s: Dict[str, float] = defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(SPAN):  # a span, also where it is drawn on the device's timeline
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                spans.append((*_times(e), name[len(SPAN):]))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            s, t = _times(e)
            device.append((s, t))
            kernel_s[name] += t - s
    win = [(s, t) for s, t, n in spans if n == WINDOW]
    if not win:
        raise RuntimeError("the trace has no window span")
    w0, w1 = win[0]
    busy = _union([(max(s, w0), min(t, w1)) for s, t in device if t > w0 and s < w1])
    inner = [(s, t, n) for s, t, n in spans if n != WINDOW]

    def holder(a, b):
        mid = 0.5 * (a + b)
        held = [(t - s, n) for s, t, n in inner if s <= mid <= t]
        return min(held)[1] if held else "outside any span"

    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                  reverse=True)
    idle_by_span: Dict[str, float] = defaultdict(float)
    for length, a, b in gaps:
        if length < 20e-6:
            break
        idle_by_span[holder(a, b)] += length
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])
    return {"window_s": w1 - w0, "busy_s": sum(t - s for s, t in busy),
            "kernel_s": dict(kernel_s), "device_ops": [[k[:200], v] for k, v in ops[:10]],
            "idle_gaps": [[holder(a, b), length] for length, a, b in gaps[:10]],
            "idle_by_span": dict(idle_by_span)}


@contextlib.contextmanager
def count_syncs(box: List[int]):
    """Counts synchronising CUDA calls inside the block into ``box[0]``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    box[0] += sum("synchroniz" in str(w.message) for w in caught)
