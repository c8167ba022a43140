"""Parallelism layer of the port (the JAX package's ``parallel/``):

- mesh.py        — the (dp, pp, fsdp, tp) DeviceMesh, each axis's group
- multihost.py   — process-group init, rank gating, cross-process gathers
- sharding.py    — the rule table, ``shard_params`` / ``gather_params`` /
                   ``batch_rows``, and the shard context the layers read
- collectives.py — the autograd-aware collectives of FSDP and tensor
                   parallelism and the point-to-point transfers, counted
                   per family
- pipeline.py    — GPipe pipeline parallelism over the stacked decoder
- ring_attention.py — ring attention (KV shards rotating over an axis)
- sequence_parallel.py — the decoder with activations cut along T

Data parallelism runs in ``training/step.py`` (the gradient all-reduce over
the mesh's ``dp`` group) and ``training/loop.py`` (each rank's rows of the
global batch, sharded validation); FSDP and tensor parallelism in the
model code under ``sharding.shard_context``.
"""

from .mesh import (
    AXES,
    DP_AXIS,
    FSDP_AXIS,
    PP_AXIS,
    TP_AXIS,
    auto_mesh,
    make_mesh,
    parse_mesh,
    single_device_mesh,
)
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
from .pipeline import pipeline_decoder_forward
from .ring_attention import ring_attention
from .sequence_parallel import sp_decoder_forward

__all__ = [
    "AXES", "DP_AXIS", "FSDP_AXIS", "PP_AXIS", "TP_AXIS", "auto_mesh", "make_mesh",
    "parse_mesh", "single_device_mesh",
    "broadcast_from_main", "gather_predictions", "initialize_distributed",
    "is_main_process", "process_count", "shard_indices", "shutdown_distributed",
    "sync_hosts", "pipeline_decoder_forward", "ring_attention", "sp_decoder_forward",
]
