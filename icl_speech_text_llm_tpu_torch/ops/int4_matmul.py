"""Weight-quantized matmul kernels, each beside its plain PyTorch version.

Counterpart of ``icl_speech_text_llm_tpu/ops/int4_matmul.py`` (K10) plus the
int8 weight-only matmul that the JAX package leaves to XLA's fused convert
(``ops/quant.py:141``; listed as K12). Both are one CUDA kernel body,
``csrc/wq_matmul.cu``:

- ``int4_matmul(x, packed, scales)``: x (M, K) bf16 @ a split-half packed
  int4 weight (K/2, N) uint8 with f32 group scales (K/group, N), the −8 zero
  point folded out of the element path as the Pallas kernel does;
- ``int8_matmul(x, q, s)``: x (M, K) bf16 @ an int8 weight (K, N), times the
  f32 per-column scale once at the end.

Each wrapper dispatches on the device of x: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises, and each counts its
launches in ``<wrapper>.launches`` (``kernels.WRAPPERS``). The stacked ``layer=`` form of the
Pallas kernel has no counterpart: ``packed[l]`` of a stacked (L, K/2, N)
weight is a contiguous view the same kernel reads in place.
"""

from __future__ import annotations

import functools

import torch

from .. import kernels

MAX_ROWS = 1024  # the gate's M bound, as the JAX package's int4_matmul_usable
TILE_N = 128     # the kernel's column tile (csrc/wq_matmul.cu kTileN)
CHUNK_K = 128    # packed weight rows per k step (csrc/wq_matmul.cu kChunk)


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The zero-fold math of the Pallas ``_int4_kernel`` in f32: per group g
    of the low half, (x_lo·lo − 8·Σx_lo)·s[g] + (x_hi·hi − 8·Σx_hi)·s[g + G/2],
    with lo/hi the unsigned nibbles; out in x's dtype."""
    M, K = x.shape
    half, N = packed.shape
    n_half = scales.shape[0] // 2
    group = half // n_half
    xf = x.float()
    x_lo = xf[:, :half].reshape(M, n_half, group).transpose(0, 1)  # (G/2, M, group)
    x_hi = xf[:, half:].reshape(M, n_half, group).transpose(0, 1)
    w = packed.reshape(n_half, group, N)
    lo = torch.bmm(x_lo, (w & 0xF).float()) - 8.0 * x_lo.sum(-1, keepdim=True)
    hi = torch.bmm(x_hi, (w >> 4).float()) - 8.0 * x_hi.sum(-1, keepdim=True)
    s = scales.float()
    acc = (lo * s[:n_half, None, :] + hi * s[n_half:, None, :]).sum(0)
    return acc.to(x.dtype)


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(x·q)·s in f32 (the kernel's math), out in x's dtype."""
    return (torch.matmul(x.float(), q.float()) * s.float()).to(x.dtype)


def int4_matmul_usable(x_shape, packed_shape, scales_shape) -> bool:
    """Gate of the K10 kernel: M ≤ ``MAX_ROWS`` and the tiles the kernel
    takes, 128-column tiles and 128-row k steps inside one scale group
    (the JAX gate's N % 128 and group % 128, which this kernel needs too)."""
    if len(x_shape) != 2 or len(packed_shape) != 2 or len(scales_shape) != 2:
        return False
    M, K = x_shape
    half, N = packed_shape
    n_groups = scales_shape[0]
    if M < 1 or M > MAX_ROWS or K != 2 * half or N % TILE_N or scales_shape[1] != N:
        return False
    if n_groups % 2 or K % n_groups:
        return False
    group = K // n_groups
    return group % CHUNK_K == 0 and half % group == 0


def int8_matmul_usable(x_shape, q_shape) -> bool:
    """Gate of the W8A16 kernel: M ≤ ``MAX_ROWS``, K in 128-row k steps and
    N in 128-column tiles."""
    if len(x_shape) != 2 or len(q_shape) != 2:
        return False
    M, K = x_shape
    return 1 <= M <= MAX_ROWS and q_shape[0] == K and K % CHUNK_K == 0 \
        and q_shape[1] % TILE_N == 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(M: int, N: int, n_chunks: int, sms: int) -> int:
    """Blocks along K: enough (column tile × row tile × split) blocks for two
    waves of the card's SMs, each split at least 2 k steps long. Decode has
    few column tiles (13B wq: 40 for 132 SMs), so without the split most of
    the card would idle while a third of it streams the weights."""
    tiles = (N // TILE_N) * -(-M // (16 if M <= 16 else 64))
    want = -(-2 * sms // tiles)
    splits = max(1, min(want, n_chunks // 2))
    per = -(-n_chunks // splits)
    return -(-n_chunks // per)


_workspaces: dict = {}


def _workspace(device_index: int, stream: int, numel: int) -> torch.Tensor:
    """The f32 split-K scratch of one (device, stream), grown as needed and
    kept: calls on one stream run in order, so a call's reduce has read it
    before the next call's partials overwrite it."""
    ws = _workspaces.get((device_index, stream))
    if ws is None or ws.numel() < numel:
        ws = torch.empty(numel, dtype=torch.float32, device=torch.device("cuda", device_index))
        _workspaces[(device_index, stream)] = ws
    return ws


def _launch(entry: str, x, w, s, K_chunks: int, N: int):
    # the decode step is bound by the host: one raw-stream query and one
    # allocation a call (torch.cuda.current_stream builds a Stream object)
    M, index = x.shape[0], x.device.index
    splits = split_k(M, N, K_chunks, _sm_count(index))
    stream = torch._C._cuda_getCurrentRawStream(index)
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    ws = _workspace(index, stream, splits * M * N).data_ptr() if splits > 1 else None
    err = getattr(kernels.lib(), entry)(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), ws, M, N, x.shape[1],
        s.shape[0] if s.dim() == 2 else 1, splits, stream)
    kernels.check(err, entry)
    return y


def _check_operands(name, x, w, s, w_dtype):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x must be bfloat16 for the CUDA kernel, got {x.dtype}")
    for what, t in (("weight", w), ("scales", s)):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} on {t.device}, x on {x.device}")
    if w.dtype != w_dtype or s.dtype != torch.float32:
        raise TypeError(f"{name}: weight must be {w_dtype} and scales float32, "
                        f"got {w.dtype} and {s.dtype}")
    if x.dim() != 2 or not (x.is_contiguous() and w.is_contiguous() and s.is_contiguous()):
        raise ValueError(f"{name}: x (M, K), weight and scales must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: x and weight must be 16-byte aligned")


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """K10: x (M, K) @ the int4 weight → (M, N) in x's dtype. ``packed`` (K/2,
    N) uint8 split-half nibbles storing v + 8, ``scales`` (K/group, N) f32."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales)
    _check_operands("int4_matmul", x, packed, scales, torch.uint8)
    if not int4_matmul_usable(x.shape, packed.shape, scales.shape):
        raise ValueError(f"int4_matmul: shapes x {tuple(x.shape)} packed {tuple(packed.shape)} "
                         f"scales {tuple(scales.shape)} are not ones the kernel takes")
    y = _launch("iclk_int4_matmul", x, packed, scales, packed.shape[0] // CHUNK_K,
                packed.shape[1])
    int4_matmul.launches += 1
    return y


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """W8A16: x (M, K) @ q (K, N) int8, times s (N,) f32 → (M, N) in x's dtype."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, s)
    _check_operands("int8_matmul", x, q, s, torch.int8)
    if not int8_matmul_usable(x.shape, q.shape) or s.shape != (q.shape[1],):
        raise ValueError(f"int8_matmul: shapes x {tuple(x.shape)} q {tuple(q.shape)} "
                         f"s {tuple(s.shape)} are not ones the kernel takes")
    y = _launch("iclk_int8_matmul", x, q, s, q.shape[0] // CHUNK_K, q.shape[1])
    int8_matmul.launches += 1
    return y


kernels.register(int4_matmul, int8_matmul)
