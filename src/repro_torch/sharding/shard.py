"""The sharded model: parameters as ``DTensor`` shards on a 2-D
``DeviceMesh``, gathered per unit, and the layers' collectives.

:func:`shard_model` places each parameter of a built
:class:`~repro_torch.models.model.DecoderLM` by the reference's rules
(:mod:`repro_torch.sharding.logical`, with the divisibility fallback of
:func:`~repro_torch.sharding.partition.spec_for_shape`): an ``nn.Parameter``
holding a ``DTensor`` whose local tensor is this rank's shard.  ``fsdp``
shards the ``embed`` dim over ``data``; heads, kv heads, ff, vocab and
experts shard over ``model``.

Each block of the stack, and the root (the embedding, the final norm and
the head), is a unit, as FSDP2 wraps one module per block: when the unit
runs, one collective per dtype gathers its parameters over ``data`` (an
all-gather along the dim the rules name; nothing for a parameter the rules
replicate), the backward reduce-scatters their gradients (sums them over
``data``: an all-reduce for a replicated parameter), and the layer code
sees plain tensors, its model shard of each weight.  Under ``remat`` the
recompute gathers again.  A parameter a layer does not compute on in
shards (the router, the recurrent layers', the norms') is also gathered
over ``model``; its gradient, the same on every model rank, keeps its own
slice.  The CUDA kernels take plain tensors, so the spectral mixer's
``fft_conv`` runs on the local rows and channels unchanged.

The layers compute Megatron-style at the points where the reference calls
``ann``: :func:`model_copy` where a replicated activation enters a
computation on model shards (identity; the backward sums the gradient over
``model``), :func:`model_sum` where model shards' partial sums become
replicated (an all-reduce; the backward is the identity), and
:func:`data_sum` for the global batch's sums in the loss and the MoE's
load-balance statistics.  Every rank holds one copy of the global loss, so
its backward gives its own rows' share of each gradient, and the unit's
reduce-scatter sums the shares: the one-device step's gradient.

Without a :func:`~repro_torch.sharding.logical.mesh_context` the helpers
are no-ops and an unsharded model runs as before.  A collective over a
group of one rank is skipped.  :data:`COUNTS` and :data:`BYTES` count the
collectives by kind.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.sharding.logical import current_mesh, mesh_context
from repro_torch.sharding.partition import placements_for, spec_for_shape

__all__ = [
    "shard_model",
    "is_sharded",
    "gathered",
    "model_copy",
    "model_sum",
    "data_sum",
    "model_max",
    "tp",
    "layout",
    "wrap",
    "whole_sum",
    "owned",
    "world_reduce",
    "local",
    "local_chunk",
    "full_tensor",
    "counts",
    "reset_counts",
    "step_collectives",
    "COUNTS",
    "BYTES",
]

#: Collectives launched, by kind, and the bytes each moved (its input's).
COUNTS: dict = {}
BYTES: dict = {}

#: The layers that compute on model shards of these weights; every other
#: parameter sharded over ``model`` is gathered over it for its layer.
LOCAL_WEIGHTS = {
    "Embedding": ("table",),
    "Head": ("w",),
    "Attention": ("wq", "wk", "wv", "wo"),
    "MLP": ("wi_gate", "wi_up", "wo"),
    "MoE": ("wi_gate", "wi_up", "wo"),
    "SpectralMixer": ("w_gate", "w_in", "w_out"),
}


def counts() -> dict:
    return {"counts": dict(COUNTS), "bytes": dict(BYTES)}


def reset_counts() -> None:
    COUNTS.clear()
    BYTES.clear()


def _count(kind: str, t: torch.Tensor) -> None:
    COUNTS[kind] = COUNTS.get(kind, 0) + 1
    BYTES[kind] = BYTES.get(kind, 0) + t.numel() * t.element_size()


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    _count("all_reduce", t)
    dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(flat: torch.Tensor, n: int, group) -> torch.Tensor:
    """(N,) on each of ``n`` ranks → (n, N), rank-major."""
    _count("all_gather", flat)
    out = flat.new_empty(n * flat.numel())
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view(n, -1)


def _reduce_scatter(rows: torch.Tensor, group) -> torch.Tensor:
    """(n, N) on each rank → (N,): this rank's row summed over the ranks."""
    _count("reduce_scatter", rows)
    out = rows.new_empty(rows.shape[1])
    dist.reduce_scatter_tensor(out, rows.reshape(-1), group=group)
    return out


# --------------------------------------------------------------------------
# the mesh context
# --------------------------------------------------------------------------


class _Axis(NamedTuple):
    group: object
    size: int
    rank: int


def _axis(name: str) -> Optional[_Axis]:
    ctx = current_mesh()
    if ctx is None:
        return None
    mesh = ctx[0]
    dim = mesh.mesh_dim_names.index(name)
    return _Axis(mesh.get_group(dim), mesh.size(dim), mesh.get_local_rank(dim))


def tp() -> Optional[_Axis]:
    """The active mesh's ``model`` axis (group, size, this rank's index), or
    None without a mesh context."""
    ctx = current_mesh()
    return None if ctx is None else _axis(ctx[1].model_axis)


def _data() -> Optional[_Axis]:
    ctx = current_mesh()
    return None if ctx is None else _axis(ctx[1].data_axis)


class _ModelCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.group), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def model_copy(x: torch.Tensor) -> torch.Tensor:
    """A replicated activation entering a computation on model shards: the
    identity, whose backward sums the gradient over ``model``."""
    ax = tp()
    return x if ax is None or ax.size == 1 else _ModelCopy.apply(x, ax.group)


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """Model shards' partial sums → the replicated sum (an all-reduce over
    ``model``; the backward is the identity)."""
    ax = tp()
    return x if ax is None or ax.size == 1 else _Sum.apply(x, ax.group)


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """A sum over this rank's rows → the sum over the global batch (an
    all-reduce over ``data``; the backward is the identity: each rank's
    copy of the loss back-propagates its own rows)."""
    ax = _data()
    return x if ax is None or ax.size == 1 else _Sum.apply(x, ax.group)


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over ``model`` of a tensor without gradient."""
    ax = tp()
    return x if ax is None or ax.size == 1 else _all_reduce(x.detach().contiguous().clone(), ax.group,
                                                            dist.ReduceOp.MAX)


# --------------------------------------------------------------------------
# placements and local chunks
# --------------------------------------------------------------------------


def local(t):
    """The local tensor of a ``DTensor`` (``t`` itself otherwise)."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def local_chunk(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's chunk of ``full`` under ``placements`` (each ``Shard(d)``
    splits dim d evenly over its mesh dim, in the mesh's order)."""
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(i)
            size = full.shape[pl.dim] // n
            full = full.narrow(pl.dim, coord[i] * size, size)
    return full


def full_tensor(t) -> torch.Tensor:
    """The whole tensor of a ``DTensor``, gathered over each mesh dim that
    shards it, the last first (collectives every rank joins); ``t`` itself
    otherwise."""
    lay = layout(t)
    if lay is None:
        return t
    mesh, dims = lay
    x = t.to_local()
    for i in reversed(range(len(dims))):
        if dims[i] is not None and mesh.size(i) > 1:
            ax = _Axis(mesh.get_group(i), mesh.size(i), mesh.get_local_rank(i))
            x = _gather_dim([x.contiguous()], [dims[i]], ax)[0]
    return x


def layout(p, stacked: bool = False):
    """(mesh, per mesh dim the dim of ``p``'s local tensor it shards, or
    None) of a ``DTensor`` (its dims shifted by one when it is stacked with
    its repeats); None for a plain tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return None
    return p.device_mesh, [pl.dim + stacked if pl.is_shard() else None for pl in p.placements]


def wrap(t: torch.Tensor, lay):
    """A local tensor as the ``DTensor`` of layout ``lay`` (``t`` itself
    for None)."""
    if lay is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, dims = lay
    shape = list(t.shape)
    for i, d in enumerate(dims):
        if d is not None:
            shape[d] *= mesh.size(i)
    placements = [Replicate() if d is None else Shard(d) for d in dims]
    return DTensor.from_local(t, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def whole_sum(x: torch.Tensor, dims, lay, keepdim: bool = False):
    """``x.sum(dims)`` over the whole tensor of layout ``lay``: the local
    sum, then summed over each mesh dim that shards one of ``dims``; and
    the count of elements summed."""
    dims = [d % x.dim() for d in (dims if isinstance(dims, (tuple, list)) else (dims,))]
    out = x.sum(dims, keepdim=keepdim)
    n = 1
    for d in dims:
        n *= x.shape[d]
    if lay is not None:
        mesh, shard_dims = lay
        for i, d in enumerate(shard_dims):
            if d is not None and d in dims and mesh.size(i) > 1:
                out = _all_reduce(out.contiguous(), mesh.get_group(i))
                n *= mesh.size(i)
    return out, n


def owned(p) -> bool:
    """Whether this rank counts ``p``'s local tensor in a sum over the whole
    tensor: it is at coordinate 0 of every mesh dim ``p`` is replicated
    over (a plain tensor: always)."""
    lay = layout(p)
    if lay is None:
        return True
    mesh, dims = lay
    return all(d is not None or c == 0 for d, c in zip(dims, mesh.get_coordinate()))


def world_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced (summed by default) over every rank of the process
    group."""
    return _all_reduce(t.contiguous(), None, op) if dist.is_initialized() and dist.get_world_size() > 1 else t


# --------------------------------------------------------------------------
# units
# --------------------------------------------------------------------------


class _Slot(NamedTuple):
    """One parameter of a unit: where it lives, the dims its data and model
    shards split, and whether its layer takes it whole over ``model``."""

    module: nn.Module
    attr: str
    data_dim: Optional[int]
    model_dim: Optional[int]
    gather_model: bool


def _flat(ts, dims) -> torch.Tensor:
    """Concatenate tensors flattened with each one's dim ``d`` moved first."""
    return torch.cat([t.movedim(d, 0).reshape(-1) for t, d in zip(ts, dims)])


def _gather_dim(ts, dims, ax: _Axis):
    """Each local shard gathered along its dim over the axis, one
    collective for all of them (one dtype)."""
    rows = _all_gather(_flat(ts, dims), ax.size, ax.group)
    out, at = [], 0
    for t, d in zip(ts, dims):
        moved = t.movedim(d, 0)
        part = rows[:, at:at + t.numel()].reshape((ax.size * moved.shape[0],) + moved.shape[1:])
        out.append(part.movedim(0, d))
        at += t.numel()
    return out


def _scatter_dim(gs, dims, ax: _Axis):
    """The gradients of :func:`_gather_dim`'s outputs summed over the axis,
    each rank keeping its own shard: one reduce-scatter."""
    rows = torch.cat([g.movedim(d, 0).reshape(ax.size, -1) for g, d in zip(gs, dims)], dim=1)
    flat = _reduce_scatter(rows.contiguous(), ax.group)
    out, at = [], 0
    for g, d in zip(gs, dims):
        moved = g.movedim(d, 0)
        shape = (moved.shape[0] // ax.size,) + moved.shape[1:]
        n = moved.numel() // ax.size
        out.append(flat[at:at + n].view(shape).movedim(0, d))
        at += n
    return out


def _by_dtype(idx, ts):
    groups: dict = {}
    for i in idx:
        groups.setdefault(ts[i].dtype, []).append(i)
    return groups.values()


class _UnitGather(torch.autograd.Function):
    """Local shards → the layer's view of each parameter; the backward
    reduces the gradients over ``data`` and keeps this rank's shards."""

    @staticmethod
    def forward(ctx, slots, data: _Axis, model: _Axis, *shards):
        ctx.slots, ctx.data, ctx.model = slots, data, model
        ctx.shapes = [(s.shape, s.dtype, s.device) for s in shards]
        out = list(shards)
        for step, ax, dim_of in ((0, data, lambda s: s.data_dim), (1, model, lambda s: s.model_dim)):
            pick = [i for i, s in enumerate(slots) if dim_of(s) is not None and (step == 0 or s.gather_model)]
            if ax.size == 1 or not pick:
                continue
            for idx in _by_dtype(pick, out):
                for i, t in zip(idx, _gather_dim([out[i] for i in idx], [dim_of(slots[i]) for i in idx], ax)):
                    out[i] = t
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        slots, data, model = ctx.slots, ctx.data, ctx.model
        gs = list(grads)
        for i, s in enumerate(slots):
            if gs[i] is None:  # a weight the loss does not reach
                shape, dtype, dev = ctx.shapes[i]
                full = list(shape)
                if s.data_dim is not None:
                    full[s.data_dim] *= data.size
                if s.gather_model and s.model_dim is not None:
                    full[s.model_dim] *= model.size
                gs[i] = torch.zeros(full, dtype=dtype, device=dev)
            if s.gather_model and s.model_dim is not None and model.size > 1:
                # The same gradient on every model rank: keep this rank's slice.
                n = gs[i].shape[s.model_dim] // model.size
                gs[i] = gs[i].narrow(s.model_dim, model.rank * n, n)
        if data.size > 1:
            sharded = [i for i, s in enumerate(slots) if s.data_dim is not None]
            for idx in _by_dtype(sharded, gs):
                for i, g in zip(idx, _scatter_dim([gs[i] for i in idx], [slots[i].data_dim for i in idx], data)):
                    gs[i] = g
            replicated = [i for i, s in enumerate(slots) if s.data_dim is None]
            for idx in _by_dtype(replicated, gs):
                flat = _all_reduce(torch.cat([gs[i].reshape(-1) for i in idx]), data.group)
                at = 0
                for i in idx:
                    gs[i] = flat[at:at + gs[i].numel()].view_as(gs[i])
                    at += gs[i].numel()
        return (None, None, None) + tuple(g.contiguous() for g in gs)


class _Unit:
    """The parameters one unit gathers, and its nesting depth (a unit
    already in force is not gathered again)."""

    def __init__(self, mesh, par, slots):
        self.mesh, self.par, self.slots, self.depth = mesh, par, slots, 0
        self.saved: list = []
        self.ctx = None

    def enter(self):
        """Gather and swap the views in, inside the mesh context (which
        stays in force, on this thread, until :meth:`exit`)."""
        self.depth += 1
        if self.depth > 1:
            return
        self.ctx = mesh_context(self.mesh, self.par)
        self.ctx.__enter__()
        params = [s.module._parameters[s.attr] for s in self.slots]
        views = _UnitGather.apply(self.slots, _data(), tp(), *[local(p) for p in params])
        self.saved = params
        for s, v in zip(self.slots, views):
            s.module._parameters[s.attr] = None  # keeps the parameters' order
            object.__setattr__(s.module, s.attr, v)

    def exit(self):
        self.depth -= 1
        if self.depth > 0:
            return
        for s, p in zip(self.slots, self.saved):
            object.__delattr__(s.module, s.attr)
            s.module._parameters[s.attr] = p
        self.saved = []
        self.ctx.__exit__(None, None, None)


def _hooks(module: nn.Module, unit: _Unit) -> None:
    module._shard_unit = unit
    module.register_forward_pre_hook(lambda mod, args: unit.enter())
    module.register_forward_hook(lambda mod, args, out: unit.exit(), always_call=True)


@contextlib.contextmanager
def gathered(model: nn.Module):
    """The root unit's parameters (embedding, final norm, head) gathered for
    the duration, inside the model's mesh context; a no-op for an
    unsharded model.  The loss and ``logits_fn`` read the head outside the
    forward."""
    if not is_sharded(model):
        yield
        return
    model._shard_unit.enter()
    try:
        yield
    finally:
        model._shard_unit.exit()


def is_sharded(model: nn.Module) -> bool:
    return getattr(model, "_sharding", None) is not None


def shard_model(model: nn.Module, mesh, par) -> nn.Module:
    """Place ``model``'s parameters on ``mesh`` (dims named by ``par``'s
    ``data_axis`` and ``model_axis``) by the rules, in place, and make each
    block and the root a unit.  Every rank must hold the same full values
    (built from one seed, or loaded); each keeps its shard.  Returns the
    model."""
    from repro_torch.utils.params import param_axes

    names = tuple(mesh.mesh_dim_names)
    if set(names) != {par.data_axis, par.model_axis} or par.pod_axis:
        raise NotImplementedError(f"the sharded model takes a 2-D mesh over ({par.data_axis!r}, "
                                  f"{par.model_axis!r}); got {names} (the pod axis: the rules only)")
    if is_sharded(model):
        raise ValueError("the model is sharded already")
    axes = param_axes(model)
    owner = {}
    for prefix, sub in model.named_modules():
        for attr, _ in sub.named_parameters(recurse=False):
            owner[f"{prefix}.{attr}" if prefix else attr] = (sub, attr)
    units: dict = {}
    data_i, model_i = names.index(par.data_axis), names.index(par.model_axis)
    for name, p in list(model.named_parameters()):
        sub, attr = owner[name]
        pl = placements_for(spec_for_shape(axes[name], tuple(p.shape), mesh, par), mesh)
        dims = [x.dim if x.is_shard() else None for x in pl]
        shard_ = wrap(local_chunk(p.detach(), mesh, pl).contiguous(), (mesh, dims))
        sub._parameters[attr] = nn.Parameter(shard_, requires_grad=p.requires_grad)
        whole = attr not in LOCAL_WEIGHTS.get(type(sub).__name__, ())
        key = name.split(".")[1] if name.startswith("stack.") else ""
        units.setdefault(key, []).append(_Slot(sub, attr, dims[data_i], dims[model_i], whole))
    for key, slots in units.items():
        _hooks(model.stack.get_submodule(key) if key else model, _Unit(mesh, par, slots))
    model._sharding = (mesh, par)
    return model


def step_collectives(model: nn.Module, seq: int, microbatches: int = 1, compression: bool = False) -> dict:
    """The collectives one AdamW or SGD train step of a sharded ``model``
    launches over sequences of ``seq`` tokens, by kind, as the units and the
    layers schedule them (a collective over one rank is skipped).  Per
    microbatch: each unit's gather per dtype at each of its runs (the
    forward, and the recompute under ``remat``), its reduce-scatter per
    dtype and the all-reduce of its parameters replicated over ``data``;
    each layer on model shards its ``model_sum`` per run (a block's MLP
    once: the recompute stops before it) and its ``model_copy`` once; the loss's per chunk of the head; the data sums of
    the loss and of each MoE run.  Per step: the global norm's (and the
    compression scale's) reduction over every rank."""
    mesh, par = model._sharding
    names = mesh.mesh_dim_names
    d, m = mesh.size(names.index(par.data_axis)), mesh.size(names.index(par.model_axis))
    cfg = model.cfg
    out = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}

    def unit(module, runs):
        slots = module._shard_unit.slots
        dtypes = lambda pick: len({s.module._parameters[s.attr].dtype for s in slots if pick(s)})  # noqa: E731
        if d > 1:
            out["all_gather"] += runs * dtypes(lambda s: s.data_dim is not None)
            out["reduce_scatter"] += dtypes(lambda s: s.data_dim is not None)
            out["all_reduce"] += dtypes(lambda s: s.data_dim is None)
        if m > 1:
            out["all_gather"] += runs * dtypes(lambda s: s.gather_model and s.model_dim is not None)

    def tp_layer(layer, runs):
        """(model_sum per run, model_copy) of one layer on model shards."""
        kind = type(layer).__name__
        if m == 1:
            return
        if kind == "Attention" and local(layer.wq).shape[1] != cfg.num_heads:
            kv_whole = local(layer.wk).shape[1] == cfg.num_kv_heads
            out["all_reduce"] += runs + 1 + 2 * kv_whole
        elif kind == "MLP" and local(layer.wo).shape[0] != layer.d_ff:
            out["all_reduce"] += runs + 1
        elif kind == "SpectralMixer" and local(layer.w_in).shape[1] != layer.d_model:
            out["all_reduce"] += runs + 2
        elif kind == "MoE" and local(layer.wi_gate).shape[0] != cfg.num_experts:
            out["all_reduce"] += runs + 2

    per_micro = dict.fromkeys(out, 0)
    saved, out = out, per_micro
    runs = 2 if cfg.remat else 1
    for block in model.stack:
        unit(block, runs)
        # The recompute stops at the block's last tensor saved for the
        # backward (torch.utils.checkpoint's early stop): the model_sum that
        # ends a block's MLP runs once; the MoE's aux follows its sums.
        last = getattr(block, "mlp", None)
        for layer in block.modules():
            tp_layer(layer, 1 if layer is last else runs)
            if type(layer).__name__ == "MoE" and d > 1:
                out["all_reduce"] += 2 * runs  # the dropped count and the aux statistics
    unit(model, 1)
    if m > 1 and local(model.embed.table).shape[0] != cfg.vocab_size:
        out["all_reduce"] += 1
    head_sharded = (local(model.embed.table).shape[0] if cfg.tie_embeddings
                    else local(model.head.w).shape[1]) != cfg.vocab_size
    if m > 1 and head_sharded:
        out["all_reduce"] += 4 * -(-seq // min(cfg.loss_chunk, seq))  # model_copy, max, Σexp, target
    if d > 1:
        out["all_reduce"] += 1  # the loss's sums
    out = {k: saved[k] + microbatches * v for k, v in per_micro.items()}
    if d * m > 1:
        out["all_reduce"] += 1 + compression
    return {k: v for k, v in out.items() if v}
