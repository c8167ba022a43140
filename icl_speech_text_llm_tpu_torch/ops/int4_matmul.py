"""Weight-quantized matmul kernels, each beside its plain PyTorch version.

Counterpart of ``icl_speech_text_llm_tpu/ops/int4_matmul.py`` (K10) plus the
int8 weight-only matmul that the JAX package leaves to XLA's fused convert
(``ops/quant.py:141``; listed as K12). Both are one CUDA kernel body,
``csrc/wq_matmul.cu``:

- ``int4_matmul(x, packed, scales)``: x (M, K) bf16 @ a split-half packed
  int4 weight (K/2, N) uint8 with f32 group scales (K/group, N), the −8 zero
  point folded into x's row sums as the Pallas kernel does;
- ``int8_matmul(x, q, s)``: x (M, K) bf16 @ an int8 weight (K, N), times the
  f32 per-column scale once at the end.

Each wrapper dispatches on the device of x: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (one launch a call: the split-K
sum happens inside a thread-block cluster) or raises, and each counts its
launches in ``<wrapper>.launches`` (``kernels.WRAPPERS``). ``partition``
chooses each call's column tile and split count from the shape alone. The
stacked ``layer=`` form of the Pallas kernel has no counterpart:
``packed[l]`` of a stacked (L, K/2, N) weight is a contiguous view the same
kernel reads in place.
"""

from __future__ import annotations

import functools
import heapq

import torch

from .. import kernels

MAX_ROWS = 1024   # the gate's M bound, as the JAX package's int4_matmul_usable
TILE_N = 128      # the gate's column tile: N in 128-column tiles
CHUNK_K = 128     # the gate's k unit: int4 groups and int8 K in 128 rows
TILES_N = (128, 64)  # the kernel's column tiles (csrc/wq_matmul.cu, TN)
STEP_ROWS = 64    # weight rows per k step of the kernel (csrc/wq_matmul.cu kStepRows)
MAX_SPLITS = 8    # CTAs of a cluster along K (csrc/wq_matmul.cu kMaxSplits)
STAGES = 3        # shared-memory stages of a block's ring (csrc/wq_matmul.cu kStages)
BLOCKS_PER_SM = 4  # the block count partition aims at, per SM


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


def split_bounds(n_steps: int, splits: int) -> list:
    """The k steps of each rank of a cluster, as the kernel takes them:
    ``n_steps // splits`` each, the first ``n_steps % splits`` ranks one
    more → [(first step, end step)] in rank order."""
    per, extra = divmod(n_steps, splits)
    bounds, begin = [], 0
    for r in range(splits):
        end = begin + per + (r < extra)
        bounds.append((begin, end))
        begin = end
    return bounds


def sm_work(M: int, N: int, n_steps: int, tile_n: int, splits: int, sms: int) -> list:
    """Model of the card's block scheduler → the k steps each of ``sms`` SMs
    streams: blocks in launch order (cluster rank fastest, then column tile,
    then row tile) each to the SM with the least work so far, which is what
    a card does where every block of the grid streams at the same rate."""
    tiles = (N // tile_n) * -(-M // (16 if M <= 16 else 64))
    loads = [(0, i) for i in range(sms)]
    sizes = [end - begin for begin, end in split_bounds(n_steps, splits)]
    for _ in range(tiles):
        for w in sizes:
            load, i = heapq.heappop(loads)
            heapq.heappush(loads, (load + w, i))
    return [load for load, _ in sorted(loads, key=lambda li: li[1])]


def balanced(work: list) -> bool:
    """The busiest SM has at most 1.1× the mean work (in integers)."""
    return 10 * max(work) * len(work) <= 11 * sum(work)


@functools.lru_cache(maxsize=None)
def partition(M: int, N: int, n_steps: int, sms: int) -> tuple:
    """(column tile, splits) of a call: among the pairs that give every SM
    the same work within 1.1× the mean (``sm_work``, ``balanced``), the one
    whose block count is nearest ``BLOCKS_PER_SM`` blocks an SM, the fewer
    splits on a tie; without a balanced pair (a product of few tiles and
    steps), the pair whose busiest SM streams the fewest bytes.

    Why: a block's start (barriers, the first loads' latency) and its end
    (the cluster's split sum) stream nothing, and blocks that share an SM
    hide them for each other, while every block costs one of each: at about
    four blocks an SM the 13B decode products ran fastest of the balanced
    pairs on the H100. Decode has few column tiles (13B wq: 40 of 128 for
    132 SMs), so without the split most of the card would idle while a
    third of it streams the weights."""
    m_tiles = -(-M // (16 if M <= 16 else 64))
    pairs = []  # (balanced, blocks, busiest SM's weight bytes, splits, tile)
    for tile_n in TILES_N:
        if N % tile_n:
            continue
        for splits in range(1, min(MAX_SPLITS, n_steps) + 1):
            work = sm_work(M, N, n_steps, tile_n, splits, sms)
            pairs.append((balanced(work), (N // tile_n) * m_tiles * splits,
                          max(work) * tile_n, splits, tile_n))
    even = [p for p in pairs if p[0]]
    if even:
        best = min(even, key=lambda p: (abs(p[1] - BLOCKS_PER_SM * sms), p[3]))
    else:
        best = min(pairs, key=lambda p: (p[2], p[1]))
    return best[4], best[3]


def _launch(entry: str, x, w, s, w_rows: int, N: int):
    # the decode step is bound by the host: one raw-stream query and one
    # allocation a call (torch.cuda.current_stream builds a Stream object)
    M, index = x.shape[0], x.device.index
    tile_n, splits = partition(M, N, w_rows // STEP_ROWS, kernels.sm_count(index))
    stream = torch._C._cuda_getCurrentRawStream(index)
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    err = getattr(kernels.lib(), entry)(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), y.data_ptr(), M, N, x.shape[1],
        s.shape[0] if s.dim() == 2 else 1, tile_n, splits, stream)
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
    if x.data_ptr() % 16 or w.data_ptr() % 16 or s.data_ptr() % 16:
        raise ValueError(f"{name}: x, weight and scales must be 16-byte aligned")


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """K10: x (M, K) @ the int4 weight → (M, N) in x's dtype. ``packed`` (K/2,
    N) uint8 split-half nibbles storing v + 8, ``scales`` (K/group, N) f32."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales)
    _check_operands("int4_matmul", x, packed, scales, torch.uint8)
    if not int4_matmul_usable(x.shape, packed.shape, scales.shape):
        raise ValueError(f"int4_matmul: shapes x {tuple(x.shape)} packed {tuple(packed.shape)} "
                         f"scales {tuple(scales.shape)} are not ones the kernel takes")
    y = _launch("iclk_int4_matmul", x, packed, scales, packed.shape[0], packed.shape[1])
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
    y = _launch("iclk_int8_matmul", x, q, s, q.shape[0], q.shape[1])
    int8_matmul.launches += 1
    return y


kernels.register(int4_matmul, int8_matmul)
