"""The yardstick: the H100's published peaks, the operations and bytes each
operation's inputs need, and the least time the card could take for them.

Counts depend on the work and not on the kernel that does it: an
attention counts the (query, key) pairs its lengths allow, each input
read once and each output written once; a quantized product reads its
packed weight and its scales once. ``opmap.json`` says which kernels may
compute each operation, so a share of the roofline is the least time of
the operations whose kernels ran over the time those kernels took.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

#: NVIDIA H100 SXM data sheet (700 W): dense bf16 tensor cores, HBM3
#: bandwidth. Every product counted here multiplies in bf16 (the int8 and
#: int4 weights are widened first), so the int8 peak does not apply.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

BF16 = 2

OPMAP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "opmap.json")


class Work:
    """Totals of flops and bytes by operation name, and model flops."""

    def __init__(self):
        self.ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0, 0.0])
        self.model_flops = 0.0

    def add(self, op: str, flops: float, nbytes: float) -> None:
        entry = self.ops[op]
        entry[0] += flops
        entry[1] += nbytes
        entry[2] += bound_seconds(flops, nbytes)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {k: {"flops": v[0], "bytes": v[1], "bound_s": v[2]} for k, v in self.ops.items()}


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time: the larger of operations over peak rate and bytes
    over peak bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


# ---- attention -------------------------------------------------------------


def attention_fwd(heads: int, kv_heads: int, hd: int, queries: int, pairs: int,
                  keys: int, elem: float = BF16) -> Tuple[float, float]:
    """Forward attention over ``pairs`` (query, key) pairs: QKᵀ and PV, 4·hd
    flops a pair a head; q and o of ``queries`` rows, k and v of ``keys``
    rows, each once."""
    flops = 4.0 * hd * heads * pairs
    nbytes = (2 * queries * heads + 2 * keys * kv_heads) * hd * elem
    return flops, nbytes


def attention_bwd(heads: int, kv_heads: int, hd: int, queries: int, pairs: int,
                  keys: int) -> Tuple[float, float]:
    """Backward without recomputation: dV = PᵀdO, dP = dO·Vᵀ, dQ = dS·K,
    dK = dSᵀQ, 8·hd flops a pair a head; q, o, dO read and dq written of
    the queries, k and v read and dk, dv written of the keys."""
    flops = 8.0 * hd * heads * pairs
    nbytes = (4 * queries * heads + 4 * keys * kv_heads) * hd * BF16
    return flops, nbytes


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def decode_attention_q8(heads: int, kv_heads: int, hd: int, cached: int) -> Tuple[float, float]:
    """One row's decode attention over ``cached`` int8 rows (one f32 scale a
    row and head, k and v) plus its own bf16 row."""
    flops = 4.0 * hd * heads * (cached + 1)
    nbytes = (2 * cached * kv_heads * (hd + 4) + 2 * kv_heads * hd * BF16
              + 2 * heads * hd * BF16)
    return flops, nbytes


def decode_attention_bf16(heads: int, kv_heads: int, hd: int, cached: int) -> Tuple[float, float]:
    flops = 4.0 * hd * heads * (cached + 1)
    nbytes = (2 * (cached + 1) * kv_heads + 2 * heads) * hd * BF16
    return flops, nbytes


# ---- weight-only quantized products ------------------------------------------


def qmatmul(m: int, k: int, n: int, bits: int, group: int = 0) -> Tuple[float, float]:
    """x (m, k) bf16 @ w (k, n) of ``bits`` with one f32 scale a column
    (``group`` 0) or a group of input rows: 2mnk flops; the packed weight,
    its scales, x and y once."""
    scales = (k // group if group else 1) * n * 4
    nbytes = k * n * bits / 8 + scales + (m * k + m * n) * BF16
    return 2.0 * m * n * k, nbytes


# ---- the device ----------------------------------------------------------------


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


# ---- shares ----------------------------------------------------------------------


def load_opmap(path: str = OPMAP, extra: Optional[Dict[str, List[str]]] = None
               ) -> Dict[str, List[str]]:
    """``opmap.json``'s operations and a family's ``extra`` ones, which add
    operations and may not redefine one of the file's."""
    with open(path) as f:
        ops = json.load(f)["ops"]
    clash = sorted(set(ops) & set(extra or {}))
    if clash:
        raise ValueError(f"a family may add operations to {path}, not redefine {clash}")
    return {**ops, **(extra or {})}


def share(ops: Iterable[str], work: Dict[str, Dict[str, float]],
          kernel_s: Dict[str, float], opmap: Dict[str, List[str]]) -> Optional[float]:
    """Percent of the roofline of ``ops``: the least time of each operation
    whose kernels ran, over the device time of those kernels; None when
    none of them ran."""
    bound, kernels = 0.0, set()
    for op in ops:
        if op not in work or op not in opmap:
            continue
        ran = {k for k in kernel_s if any(re.search(p, k) for p in opmap[op])}
        if not ran:
            continue
        bound += work[op]["bound_s"]
        kernels |= ran
    spent = sum(kernel_s[k] for k in kernels)
    if not kernels or spent <= 0:
        return None
    return 100.0 * bound / spent
