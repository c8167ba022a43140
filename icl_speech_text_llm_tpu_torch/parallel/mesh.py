"""Device mesh construction.

Counterpart of ``icl_speech_text_llm_tpu/parallel/mesh.py``: the JAX
package's ``(dp, pp, fsdp, tp)`` mesh, here a
``torch.distributed.device_mesh.DeviceMesh`` over the process group (one
process per card, or per CPU process under gloo), with JAX's axis names.
Data parallelism is the ``dp`` axis: each rank steps its rows of the global
batch and the gradients are summed over the axis's group
(``training/step.py``).

Only ``fsdp = tp = pp = 1`` is ported: the sharding rules (FSDP, tensor
parallelism) and the pipeline raise ``NotImplementedError`` (ROADMAP.md
queue 1 item 3).
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
    if fsdp != 1 or tp != 1 or pp != 1:
        raise NotImplementedError(
            f"mesh dp{dp}xpp{pp}xfsdp{fsdp}xtp{tp}: only data parallelism (fsdp = tp = pp "
            "= 1) is ported; FSDP, tensor and pipeline parallelism are ROADMAP.md queue 1 "
            "item 3")
    want = dp * fsdp * tp * pp
    if not dist.is_initialized() and want == 1:
        initialize_distributed(num_processes=1, process_id=0, device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if want != world:
        raise ValueError(
            f"mesh dp{dp}xpp{pp}xfsdp{fsdp}xtp{tp} = {want} != {world} processes")
    return init_device_mesh(torch.device(device).type, (dp, pp, fsdp, tp),
                            mesh_dim_names=AXES)
