"""Parameter specs: logical axes → mesh placements with divisibility
fallback (a mesh axis that does not divide a dim is dropped to replication —
e.g. kv_heads=8 on a model=16 axis).

Port of ``repro/sharding/partition.py``.  A mesh here is a
``torch.distributed`` ``DeviceMesh`` with named dims, or any object whose
``.shape`` maps axis names to sizes (enough for the specs alone, as the
reference's rules read only ``mesh.shape``).  :func:`placements_for` turns a
spec into ``DTensor`` placements and stands in for the reference's
``param_shardings``: per mesh dim, ``Shard(i)`` where array dim ``i``'s
entry names that mesh axis, else ``Replicate()``.
"""

from __future__ import annotations

import math

from repro_torch.configs.base import ParallelConfig
from repro_torch.sharding.logical import rules_for

__all__ = ["axis_size", "spec_for_shape", "param_specs", "batch_specs", "check_divisible", "placements_for"]


def axis_size(mesh, phys) -> int:
    """The size of a mesh axis, or the product over a tuple of them."""
    if phys is None:
        return 1
    if isinstance(phys, str):
        shape = mesh.shape
        if isinstance(shape, dict):
            return int(shape[phys])
        return int(mesh.size(mesh.mesh_dim_names.index(phys)))
    return math.prod(axis_size(mesh, p) for p in phys)


def _spec_entry(name, dim, mesh, rules, used):
    if name is None:
        return None
    phys = rules.get(name)
    if phys is None:
        return None
    phys = tuple(p for p in phys if p not in used)
    # drop trailing axes until the product divides the dim
    while phys and dim % axis_size(mesh, phys) != 0:
        phys = phys[:-1]
    if not phys:
        return None
    used.update(phys)
    return phys if len(phys) > 1 else phys[0]


def spec_for_shape(axes: tuple, shape: tuple, mesh, par: ParallelConfig) -> tuple:
    rules = rules_for(par)
    used: set = set()
    return tuple(_spec_entry(name, dim, mesh, rules, used) for name, dim in zip(axes, shape))


def param_specs(axes: dict, shapes: dict, mesh, par: ParallelConfig) -> dict:
    """Spec per parameter name, from its logical axes and its shape."""
    return {name: spec_for_shape(tuple(axes[name]), tuple(shapes[name]), mesh, par) for name in axes}


def batch_specs(batch: dict, mesh, par: ParallelConfig) -> dict:
    """Every batch input over ('pod', 'data') on dim 0 when divisible."""
    batch_axes = rules_for(par)["batch"]

    def one(x):
        if x.ndim == 0:
            return ()
        entry = _spec_entry("batch", x.shape[0], mesh, {"batch": batch_axes}, set())
        return (entry,) + (None,) * (x.ndim - 1)

    return {k: one(v) for k, v in batch.items()}


def check_divisible(shape, spec: tuple, mesh) -> bool:
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is not None and dim % axis_size(mesh, entry) != 0:
            return False
    return True


def placements_for(spec: tuple, mesh) -> list:
    """``DTensor`` placements of ``spec`` on ``mesh``'s dims, in the mesh's
    order.  An array dim sharded over several mesh axes is split over them
    in the entry's order, which is the mesh's order for the rules' entries
    (``('pod', 'data')``)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec) if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out
