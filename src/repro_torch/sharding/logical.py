"""Logical-axis → mesh-axis rules (t5x/MaxText style).

Port of ``repro/sharding/logical.py``.  Model code names array axes
logically (``'batch'``, ``'heads'``, ``'ff'``, ...); this module maps them
to the axes of a ``torch.distributed`` ``DeviceMesh`` given a
:class:`~repro_torch.configs.base.ParallelConfig`.  A spec is a tuple with
one entry per array axis: ``None`` (replicated), a mesh axis name, or a
tuple of names (one array axis sharded over several mesh axes, in that
order); ``tuple(spec)`` compares equal to the reference's ``PartitionSpec``.

Parallelism coverage:
  DP    batch        → ('pod', 'data')
  TP    heads/ff/vocab/experts → 'model'
  FSDP  embed (params' largest replicated axis) → 'data' when enabled
  EP    experts      → 'model'
  SP    kv_seq / long sequences → 'data' when sequence_parallel

:func:`ann` annotates an activation: a ``DTensor`` is redistributed to the
rule's placements; the sharded model's layers compute on plain local
shards whose placement already is the rule's, and they pass through.
Outside a :func:`mesh_context` it is a no-op, so the same model code runs
on one device.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from repro_torch.configs.base import ParallelConfig

__all__ = ["rules_for", "spec_for", "ann", "mesh_context", "current_mesh", "data_shard_count"]

_state = threading.local()


def rules_for(par: ParallelConfig) -> dict[str, Optional[tuple]]:
    batch_axes = (par.pod_axis, par.data_axis) if par.pod_axis else (par.data_axis,)
    model = (par.model_axis,)
    rules: dict[str, Optional[tuple]] = {
        "batch": batch_axes,
        "seq": None,
        "kv_seq": (par.data_axis,) if par.sequence_parallel else None,
        # FSDP shards params over every data-parallel axis (pod included on
        # the multi-pod mesh); activations never see it ('batch' claims the
        # data axes first and duplicates are dropped).
        "embed": batch_axes if par.fsdp else None,
        "heads": model,
        "kv_heads": model,
        "head_dim": None,
        "ff": model,
        "vocab": model,
        "experts": model,
        "expert_ff": None,
        "state": None,
        "conv": None,
        "filter": None,
        "frames": None,
    }
    if par.decode_weight_stationary:
        # One-token decode with FSDP weights: replicate the (tiny) batch and
        # contract the data-sharded embed dim locally — small all-reduces
        # instead of per-layer full weight all-gathers.
        rules.update(batch=None, seq=None, embed=batch_axes)
    return rules


def spec_for(axes: tuple, par: ParallelConfig) -> tuple:
    """The spec of a tuple of logical axis names (None = replicated)."""
    rules = rules_for(par)
    entries = []
    used: set[str] = set()
    for name in axes:
        phys = rules.get(name) if name is not None else None
        # A mesh axis may appear at most once in a spec.
        phys = tuple(p for p in phys if p not in used) if phys else ()
        if not phys:
            entries.append(None)
            continue
        used.update(phys)
        entries.append(phys if len(phys) > 1 else phys[0])
    return tuple(entries)


@contextlib.contextmanager
def mesh_context(mesh, par: ParallelConfig):
    """Activate the sharded layers' collectives (and :func:`ann`) within
    ``mesh`` (a ``DeviceMesh``, or anything with a ``.shape`` mapping for
    the rules alone)."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, par)
    try:
        yield
    finally:
        _state.ctx = prev


def current_mesh() -> Optional[tuple]:
    """The active ``(mesh, par)``, or None outside a :func:`mesh_context`."""
    return getattr(_state, "ctx", None)


def data_shard_count() -> int:
    """Number of data-parallel shards (pod·data) in the active mesh (1 if none)."""
    ctx = current_mesh()
    if ctx is None:
        return 1
    from repro_torch.sharding.partition import axis_size

    mesh, par = ctx
    return axis_size(mesh, (par.pod_axis, par.data_axis) if par.pod_axis else par.data_axis)


def ann(x, *axes):
    """Annotate an activation with logical axes (no-op without a mesh): a
    ``DTensor`` is redistributed to the rule's placements; a plain tensor
    (a local shard already in the rule's placement) is returned as it is."""
    ctx = current_mesh()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding.partition import placements_for

    mesh, par = ctx
    return x.redistribute(mesh, placements_for(spec_for(axes, par), mesh))
