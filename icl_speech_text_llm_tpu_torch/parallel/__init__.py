"""Parallelism layer of the port (the JAX package's ``parallel/``):

- mesh.py      — the (dp, pp, fsdp, tp) DeviceMesh; data parallelism only
- multihost.py — process-group init, rank gating, cross-process gathers

Data parallelism runs in ``training/step.py`` (the gradient all-reduce over
the mesh's ``dp`` group) and ``training/loop.py`` (each rank's rows of the
global batch, sharded validation). The JAX package's sharding rules,
pipeline, ring attention and sequence parallelism are not ported yet
(ROADMAP.md queue 1 item 3).
"""

from .mesh import AXES, DP_AXIS, FSDP_AXIS, PP_AXIS, TP_AXIS, make_mesh, parse_mesh
from .multihost import (
    broadcast_from_main,
    gather_predictions,
    initialize_distributed,
    is_main_process,
    process_count,
    shard_indices,
    shutdown_distributed,
    sync_hosts,
)

__all__ = [
    "AXES", "DP_AXIS", "FSDP_AXIS", "PP_AXIS", "TP_AXIS", "make_mesh", "parse_mesh",
    "broadcast_from_main", "gather_predictions", "initialize_distributed",
    "is_main_process", "process_count", "shard_indices", "shutdown_distributed",
    "sync_hosts",
]
