"""Process coordination for data parallelism across processes.

Counterpart of ``icl_speech_text_llm_tpu/parallel/multihost.py``: the
reference's ``dist.init_process_group("nccl")`` + rank gating (ref:
train/train.py:136-141,623) and its ``DistributedSampler`` (:325-330) over
``torch.distributed``. NCCL connects the processes of cards, gloo those of
the CPU; main-process gating is ``rank == 0``. Without a process group
every helper degrades to the one-process answer, as JAX's do on one host.

Under NCCL a collective takes only tensors on the rank's card, so the
gathered prediction buffers and the broadcast objects go through it
(``torch.cuda.set_device`` is called when the group starts); under gloo
they stay on the host.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    backend: Optional[str] = None,
) -> int:
    """Join this process to the group and return its rank.

    The arguments, or else torchrun's environment (``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), name the group;
    where neither does this is a no-op (rank 0). ``coordinator_address`` is
    ``host:port`` of rank 0's store; a group of one without one keeps its
    store in this process. ``backend`` defaults to NCCL for a ``cuda``
    device and gloo for ``cpu`` (two processes sharing one card need gloo:
    NCCL refuses a card twice in one group). A process on a card first
    selects ``cuda:LOCAL_RANK`` (its rank when no launcher set it).
    """
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if coordinator_address is None and num_processes is None and "WORLD_SIZE" not in env:
        return 0
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=rank)
    elif "MASTER_ADDR" in env:  # torchrun's store
        dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank)
    elif world == 1:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        raise ValueError(f"a group of {world} processes needs a coordinator address")
    logger.info(f"torch.distributed initialized: process {rank} / {world} ({backend})")
    return rank


def shutdown_distributed() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank-0 gating for logging/checkpointing (ref: train/train.py:139-141)."""
    return process_index() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def sync_hosts(name: str = "barrier") -> None:
    """Barrier across processes (no-op with one)."""
    if process_count() > 1:
        dist.barrier()


def _collective_device(group=None) -> torch.device:
    """Where a collective's buffers live: the rank's card under NCCL, else
    the host."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_from_main(tree: Any) -> Any:
    """Replicate host-local data from process 0 to all processes (e.g.
    symbol mappings, shuffled index orders) so every process packs
    identical batches."""
    if process_count() <= 1:
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0, device=_collective_device())
    return box[0]


def encode_rows(rows: List[dict]) -> np.ndarray:
    """Prediction rows (string-bearing dicts) → uint8 JSON buffer.

    A collective moves tensors, not Python objects — string rows ride a
    fixed-dtype buffer."""
    return np.frombuffer(json.dumps(rows).encode("utf-8"), dtype=np.uint8).copy()


def decode_rows(buf: np.ndarray, length: int) -> List[dict]:
    return json.loads(np.asarray(buf[:length], np.uint8).tobytes().decode("utf-8"))


def gather_predictions(rows: list) -> list:
    """Gather per-process prediction lists onto every process for global
    metrics.

    The reference computed validation metrics per-rank and only rank 0 logged
    (SURVEY.md §5.8) — a silent correctness gap for sharded eval; this gathers
    so metrics cover the full set. Rows are JSON-encoded into uint8 buffers
    padded to the longest, and all-gathered with their lengths.
    """
    world = process_count()
    if world <= 1:
        return rows
    dev = _collective_device()
    payload = torch.from_numpy(encode_rows(rows)).to(dev)
    n = torch.tensor([payload.numel()], dtype=torch.int64, device=dev)
    sizes = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(sizes, n)
    lengths = [int(s.item()) for s in sizes]
    padded = torch.zeros(max(lengths), dtype=torch.uint8, device=dev)
    padded[: payload.numel()] = payload
    gathered = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(gathered, padded)
    out: list = []
    for buf, length in zip(gathered, lengths):
        out.extend(decode_rows(buf.cpu().numpy(), length))
    return out


def shard_indices(
    n: int,
    epoch: int = 0,
    shuffle: bool = True,
    seed: int = 0,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
) -> np.ndarray:
    """Per-process dataset index slice with per-epoch reshuffle.

    The reference's ``DistributedSampler`` + ``set_epoch`` (ref:
    train/train.py:325-330,418-419): every process draws the SAME
    permutation (seeded by seed+epoch), the order wraps around so the total
    is divisible by the process count, and process p takes ``order[p::P]``.
    With one process this is just the (shuffled) full index list.
    """
    pid = process_index() if process_id is None else process_id
    pc = process_count() if num_processes is None else num_processes
    order = (np.random.RandomState(seed + epoch).permutation(n) if shuffle
             else np.arange(n))
    if pc <= 1:
        return order
    pad = (-n) % pc
    if pad:
        order = np.concatenate([order, order[:pad]])
    return order[pid::pc]
