"""Device-memory streaming probe (K11), beside its plain PyTorch version.

Counterpart of the JAX package's two streaming probes,
``scripts/probe_stream_matrix.py`` (``run_2d``) and
``scripts/probe_kernel_variants.py`` (``launch`` with ``k_stream``): Pallas
kernels that read a buffer tile by tile so that the chip's streaming rate can
be timed. Their outputs (sums of an 8×128 corner of each tile) are a
measurement trick; this port's probe computes a function that needs every
byte instead: ``stream_read(x)`` sums a bf16 buffer in f32 into ``blocks``
per-block partial sums, block i covering the i-th contiguous chunk of
``ceil(n / 8 / blocks)`` groups of 8 elements (``csrc/stream_probe.cu``).
Timing it gives the rate that the bytes-bound kernels are read against.

As in ``flash_attention``, a CPU tensor takes the plain version and a CUDA
tensor launches the kernel or raises; launches are counted on the wrapper.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels

PROBE_BLOCKS = 1024  # partial sums per call: ~8 resident blocks per H100 SM


def _chunk_vectors(n: int, blocks: int) -> int:
    """Groups of 8 elements per block for a buffer of ``n`` elements."""
    n_vec = -(-n // 8)
    return -(-n_vec // blocks)


def stream_read_plain(x: torch.Tensor, blocks: int = PROBE_BLOCKS) -> torch.Tensor:
    """The probe's function in PyTorch: the f32 sums of ``blocks`` contiguous
    chunks of ``x`` (flattened, zero-padded at the end) → (blocks,) f32."""
    flat = x.reshape(-1).float()
    chunk = 8 * _chunk_vectors(flat.numel(), blocks)
    flat = F.pad(flat, (0, chunk * blocks - flat.numel()))
    return flat.view(blocks, chunk).sum(1)


def stream_read(x: torch.Tensor, blocks: int = PROBE_BLOCKS) -> torch.Tensor:
    """K11: read every byte of the bf16 buffer ``x`` once → (blocks,) f32
    partial sums, as ``stream_read_plain``. On the card ``x`` must be
    contiguous, 16-byte aligned and hold a multiple of 8 elements."""
    if blocks <= 0:
        raise ValueError(f"blocks must be positive, got {blocks}")
    if x.device.type == "cpu":
        return stream_read_plain(x, blocks)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"stream_read: x must be bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16 or x.numel() % 8 or x.numel() == 0:
        raise ValueError("stream_read: x must be contiguous, 16-byte aligned and hold a "
                         f"non-zero multiple of 8 elements (got {x.numel()})")
    partial = torch.empty((blocks,), dtype=torch.float32, device=x.device)
    err = kernels.lib().iclk_stream_read(
        x.data_ptr(), partial.data_ptr(), x.numel() // 8, blocks,
        torch._C._cuda_getCurrentRawStream(x.device.index))
    kernels.check(err, "stream_read")
    stream_read.launches += 1
    return partial


def stream_rate(x: torch.Tensor, reps: int = 20) -> float:
    """The probe as the JAX scripts run it: the rate, in GB/s, at which
    ``stream_read`` reads ``x`` on the card, from CUDA events around ``reps``
    launches after one warm-up. Only the card has a rate to measure: a CPU
    tensor raises."""
    if x.device.type != "cuda":
        raise ValueError(f"stream_rate measures a CUDA device, got a tensor on {x.device}")
    if reps <= 0:
        raise ValueError(f"reps must be positive, got {reps}")
    stream_read(x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        stream_read(x)
    end.record()
    end.synchronize()
    return x.numel() * x.element_size() * reps / (start.elapsed_time(end) * 1e6)


kernels.register(stream_read)
