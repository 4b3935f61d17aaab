"""Mesh construction over the current process group.

Port of ``repro/launch/mesh.py``: the reference's ``Mesh`` is a
``torch.distributed`` ``DeviceMesh`` with named dims.  ``make_mesh`` spans
the group ``torch.distributed`` was initialised with (the caller sets it
up: ``torchrun``'s environment, or ``init_process_group`` with an address,
world size and rank), on the card by default or on the CPU when asked.
``make_production_mesh`` is a function, so importing this module touches no
device and no group.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.configs.base import ParallelConfig

__all__ = ["make_production_mesh", "parallel_config_for", "make_mesh"]


def make_mesh(shape, axes, *, device=None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    current process group, whose world size must be the shape's product;
    ``device`` None is the card, ``"cpu"`` the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"mesh {shape}: no process group (torch.distributed.init_process_group first)")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    device_type = "cuda" if device is None else str(device).split(":")[0]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production mesh: (16, 16) over ('data', 'model'), or
    (2, 16, 16) over ('pod', 'data', 'model'); raises naming the world size
    it needs when the group is smaller."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def parallel_config_for(mesh, *, fsdp: bool = False, sequence_parallel: bool = False) -> ParallelConfig:
    axis_names = tuple(mesh.mesh_dim_names)
    return ParallelConfig(
        data_axis="data" if "data" in axis_names else axis_names[0],
        model_axis="model" if "model" in axis_names else axis_names[-1],
        pod_axis="pod" if "pod" in axis_names else None,
        fsdp=fsdp,
        sequence_parallel=sequence_parallel,
    )
