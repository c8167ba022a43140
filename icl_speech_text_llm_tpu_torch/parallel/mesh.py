"""Device mesh construction.

Counterpart of ``icl_speech_text_llm_tpu/parallel/mesh.py``: the JAX
package's ``(dp, pp, fsdp, tp)`` mesh, here a
``torch.distributed.device_mesh.DeviceMesh`` over the process group (one
process per card, or per CPU process under gloo), with JAX's axis names.
Data parallelism is the ``dp`` axis: each rank steps its rows of the global
batch and the gradients are summed over the axis's group
(``training/step.py``); ``fsdp`` shards the big matrices' other dim and
the batch too, ``tp`` the heads, columns and vocabulary
(``parallel/sharding.py``), and ``pp`` the decoder's layers into stages
of a GPipe schedule (``parallel/pipeline.py``; the ranks that differ only
in pp are one pipeline). Each axis has its sub-group and this rank's
coordinate on it (``axis_group``, ``axis_rank``, ``axis_size``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .multihost import initialize_distributed

DP_AXIS = "dp"
PP_AXIS = "pp"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"
AXES = (DP_AXIS, PP_AXIS, FSDP_AXIS, TP_AXIS)


def parse_mesh(spec: str):
    """``'dp,fsdp,tp[,pp]'`` (the train CLI's ``--mesh``) → (dp, fsdp, tp, pp);
    missing sizes are 1."""
    sizes = [int(x) for x in spec.split(",")]
    dp, fsdp, tp = (sizes + [1, 1, 1])[:3]
    pp = sizes[3] if len(sizes) > 3 else 1
    return dp, fsdp, tp, pp


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1, pp: int = 1,
              device="cuda") -> DeviceMesh:
    """Build a (dp, pp, fsdp, tp) mesh over the process group.

    Axis sizes must multiply to the world size. Without a process group a
    mesh of one starts a group of one (its store in this process), so the
    data-parallel step runs its reductions even alone.
    """
    want = dp * fsdp * tp * pp
    if not dist.is_initialized() and want == 1:
        initialize_distributed(num_processes=1, process_id=0, device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if want != world:
        raise ValueError(
            f"mesh dp{dp}xpp{pp}xfsdp{fsdp}xtp{tp} = {want} != {world} processes")
    return init_device_mesh(torch.device(device).type, (dp, pp, fsdp, tp),
                            mesh_dim_names=AXES)


def single_device_mesh(device="cuda") -> DeviceMesh:
    """A mesh of one (a group of one when none is running)."""
    return make_mesh(1, 1, 1, device=device)


def auto_mesh(n_devices=None, prefer_tp: int = 1, device="cuda") -> DeviceMesh:
    """Every process on dp unless a tp degree that divides them is asked."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    tp = prefer_tp if n % prefer_tp == 0 else 1
    return make_mesh(dp=n // tp, fsdp=1, tp=tp, device=device)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This process's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of the ranks that differ from this one only on
    ``axis``."""
    return mesh.get_group(axis)
