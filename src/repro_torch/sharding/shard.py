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

A decode step of a model sharded with ``decode_weight_stationary`` (the
reference's weight-stationary FSDP decode, :func:`decoding`) gathers
nothing over ``data``: the weights stay the training shards, the one-token
batch is replicated over ``data`` and the residual stream is this rank's
slice of ``embed`` (B, 1, D/data).  A layer contracts that slice against
its (D/data, out) shard and sums the partial products over ``data``
(:func:`ws_in`); its output projection's (in, D/data) shard gives the
rank's slice of the stream (a ``model_sum`` where ``in`` is over
``model``).  Only the sLSTM's weights and the spectral filter, which no
layer computes on by ``embed`` slices, are gathered over ``data`` then.

Without a :func:`~repro_torch.sharding.logical.mesh_context` the helpers
are no-ops and an unsharded model runs as before.  A collective over a
group of one rank is skipped.  :data:`COUNTS` and :data:`BYTES` count the
collectives by kind, :data:`BY_AXIS` by kind and the mesh axis they ran
over (``data``, ``model`` or ``world``; a unit's gathers of its weights
tagged ``:weights``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.sharding.logical import current_mesh, mesh_context
from repro_torch.sharding.partition import placements_for, spec_for_shape
from repro_torch.utils.params import cast

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
    "decode_collectives",
    "unit_scope",
    "context",
    "model_gather",
    "data_rows",
    "decoding",
    "ws",
    "ws_in",
    "data_sum_all",
    "data_rank",
    "own_rows",
    "axes_size",
    "stream_slice",
    "stream_full",
    "data_gather",
    "seq_reduce",
    "COUNTS",
    "BYTES",
    "BY_AXIS",
]

#: Collectives launched, by kind, and the bytes each moved (its input's);
#: by ``"kind:axis"``.
COUNTS: dict = {}
BYTES: dict = {}
BY_AXIS: dict = {}

#: The weights a weight-stationary decode still gathers over ``data``:
#: the sLSTM's (its recurrence runs on the whole state) and the spectral
#: filter (its rows are the channels of the ``model`` shard).
WS_GATHERED = {"SLSTM": ("w_x", "w_h", "bias", "w_out"), "SpectralMixer": ("filt",)}

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
    return {"counts": dict(COUNTS), "bytes": dict(BYTES), "by_axis": dict(BY_AXIS)}


def reset_counts() -> None:
    COUNTS.clear()
    BYTES.clear()
    BY_AXIS.clear()


def _axis_name(group) -> str:
    """The mesh axis ``group`` spans in the active mesh (``world`` for the
    process group itself)."""
    ctx = current_mesh()
    if group is None or ctx is None:
        return "world"
    mesh, par = ctx
    key = getattr(group, "group_name", id(group))
    for name in (par.data_axis, par.model_axis):
        g = mesh.get_group(mesh.mesh_dim_names.index(name))
        if g is group or getattr(g, "group_name", None) == key:
            return name
    return "world"


def _count(kind: str, t: torch.Tensor, group=None, weights: bool = False) -> None:
    COUNTS[kind] = COUNTS.get(kind, 0) + 1
    BYTES[kind] = BYTES.get(kind, 0) + t.numel() * t.element_size()
    key = f"{kind}:{_axis_name(group)}" + (":weights" if weights else "")
    BY_AXIS[key] = BY_AXIS.get(key, 0) + 1


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    _count("all_reduce", t, group)
    dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(flat: torch.Tensor, n: int, group, weights: bool = False) -> torch.Tensor:
    """(N,) on each of ``n`` ranks → (n, N), rank-major (``weights``: a
    unit's parameters, so counted)."""
    _count("all_gather", flat, group, weights)
    out = flat.new_empty(n * flat.numel())
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view(n, -1)


def _reduce_scatter(rows: torch.Tensor, group) -> torch.Tensor:
    """(n, N) on each rank → (N,): this rank's row summed over the ranks."""
    _count("reduce_scatter", rows, group)
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


def model_gather(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Model shards of ``x`` along ``dim`` (a tensor without gradient, this
    rank's vocab slice of the logits) joined in rank order: an all-gather
    over ``model``."""
    ax = tp()
    if ax is None or ax.size == 1:
        return x
    return _gather_dim([x.detach().contiguous()], [dim % x.dim()], ax)[0]


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over ``model`` of a tensor without gradient."""
    ax = tp()
    return x if ax is None or ax.size == 1 else _all_reduce(x.detach().contiguous().clone(), ax.group,
                                                            dist.ReduceOp.MAX)


# --------------------------------------------------------------------------
# weight-stationary decode and the sequence-sharded cache
# --------------------------------------------------------------------------

_ws_state = threading.local()


def ws() -> bool:
    """Whether a weight-stationary decode step is in force on this thread."""
    return getattr(_ws_state, "on", False)


@contextlib.contextmanager
def decoding(model: nn.Module):
    """``model``'s decode step: weight-stationary for a model sharded with
    ``decode_weight_stationary`` (the reference's ``par_act``), else as its
    forward runs."""
    prev = ws()
    _ws_state.on = is_sharded(model) and model._sharding[1].decode_weight_stationary
    try:
        yield
    finally:
        _ws_state.on = prev


def data_rank() -> int:
    """This rank's index on ``data`` (0 without a mesh context)."""
    ax = _data()
    return 0 if ax is None else ax.rank


def axes_size(axes: tuple) -> int:
    """The ranks of the active mesh's axes ``axes`` (1 for none, or without
    a mesh context)."""
    ctx = current_mesh()
    if ctx is None:
        return 1
    mesh = ctx[0]
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def _split_like(flat: torch.Tensor, ts) -> tuple:
    out, at = [], 0
    for t in ts:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return tuple(out)


def data_sum_all(*ts) -> tuple:
    """Each of ``ts`` (one dtype, no gradient) summed over ``data``: one
    all-reduce for all of them."""
    ax = _data()
    if ax is None or ax.size == 1:
        return ts
    return _split_like(_all_reduce(torch.cat([t.reshape(-1) for t in ts]), ax.group), ts)


def ws_in(x: torch.Tensor, *weights) -> tuple:
    """``x`` (..., D) times each of ``weights`` (D, ...) flattened after its
    first dim, cast to ``x``'s dtype: (..., out) each.  Under a
    weight-stationary decode ``x`` is this rank's slice of ``embed`` and
    each weight its (D/data, ...) shard, so the partial products are summed
    over ``data``, one all-reduce for all of them."""
    outs = tuple(x @ cast(w, x.dtype).flatten(1) for w in weights)
    return data_sum_all(*outs) if ws() else outs


def stream_slice(x: torch.Tensor) -> torch.Tensor:
    """Under a weight-stationary decode, this rank's ``embed`` slice of the
    last dim of ``x``; ``x`` otherwise."""
    ax = _data()
    if not ws() or ax is None or ax.size == 1:
        return x
    n = x.shape[-1] // ax.size
    return x.narrow(-1, ax.rank * n, n)


def stream_full(x: torch.Tensor) -> torch.Tensor:
    """Under a weight-stationary decode, the whole ``embed`` dim of a slice
    (..., D/data) of the stream, gathered over ``data``; ``x`` otherwise."""
    ax = _data()
    if not ws() or ax is None or ax.size == 1:
        return x
    return _gather_dim([x.contiguous()], [x.dim() - 1], ax)[0]


def own_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """This rank's ``rows`` rows of a weight-stationary step's replicated
    batch ``x`` (dim 0), for a decode state that holds its data shard's
    rows only; ``x`` itself where the state holds all of them."""
    return x if x.shape[0] == rows else x.narrow(0, data_rank() * rows, rows)


def data_gather(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The data ranks' shards of ``x`` (no gradient) along ``dim`` joined in
    rank order: an all-gather over ``data``."""
    ax = _data()
    if ax is None or ax.size == 1:
        return x
    return _gather_dim([x.contiguous()], [dim % x.dim()], ax)[0]


def seq_reduce(axes: tuple, *ts, op: str = "sum") -> tuple:
    """Each of ``ts`` (one dtype, no gradient) summed, or its elementwise
    max for ``op="max"``, over the ranks of the mesh axes ``axes`` (a
    sequence-sharded cache's group): one all-reduce over the process group
    where the axes span the whole mesh and world, else one per axis."""
    ctx = current_mesh()
    if ctx is None or not axes:
        return ts
    groups = _reduce_groups(ctx[0], axes)
    if not groups:
        return ts
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    flat = torch.cat([t.reshape(-1) for t in ts])
    for group in groups:
        flat = _all_reduce(flat, group, red)
    return _split_like(flat, ts)


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
    shards split, whether its layer takes it whole over ``model``, and
    whether a weight-stationary decode gathers it over ``data``."""

    module: nn.Module
    attr: str
    data_dim: Optional[int]
    model_dim: Optional[int]
    gather_model: bool
    ws_gather: bool = False


def _flat(ts, dims) -> torch.Tensor:
    """Concatenate tensors flattened with each one's dim ``d`` moved first."""
    return torch.cat([t.movedim(d, 0).reshape(-1) for t, d in zip(ts, dims)])


def _gather_dim(ts, dims, ax: _Axis, weights: bool = False):
    """Each local shard gathered along its dim over the axis, one
    collective for all of them (one dtype)."""
    rows = _all_gather(_flat(ts, dims), ax.size, ax.group, weights)
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
    reduces the gradients over ``data`` and keeps this rank's shards.
    Under a weight-stationary decode (``stationary``) only the slots marked
    ``ws_gather`` are gathered over ``data``."""

    @staticmethod
    def forward(ctx, slots, data: _Axis, model: _Axis, stationary: bool, *shards):
        ctx.slots, ctx.data, ctx.model = slots, data, model
        ctx.shapes = [(s.shape, s.dtype, s.device) for s in shards]
        out = list(shards)
        over_data = (lambda s: s.ws_gather) if stationary else (lambda s: True)  # noqa: E731
        for step, ax, dim_of in ((0, data, lambda s: s.data_dim), (1, model, lambda s: s.model_dim)):
            pick = [i for i, s in enumerate(slots)
                    if dim_of(s) is not None and (s.gather_model if step else over_data(s))]
            if ax.size == 1 or not pick:
                continue
            for idx in _by_dtype(pick, out):
                for i, t in zip(idx, _gather_dim([out[i] for i in idx], [dim_of(slots[i]) for i in idx], ax, True)):
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
        return (None, None, None, None) + tuple(g.contiguous() for g in gs)


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
        views = _UnitGather.apply(self.slots, _data(), tp(), ws(), *[local(p) for p in params])
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


@contextlib.contextmanager
def unit_scope(module: nn.Module):
    """``module``'s unit (a block of a sharded model) gathered for the
    duration, as its forward gathers it: how a decode step, which calls
    ``Block.decode`` and not the module, runs on a sharded block.  A no-op
    for a module that is no unit."""
    unit = getattr(module, "_shard_unit", None)
    if unit is None:
        yield
        return
    unit.enter()
    try:
        yield
    finally:
        unit.exit()


def context(model: nn.Module):
    """The model's mesh context (no gather: the parameters stay the
    ``DTensor`` shards, which :func:`local` reads), or a null context for an
    unsharded model."""
    return mesh_context(*model._sharding) if is_sharded(model) else contextlib.nullcontext()


def data_rows(model: nn.Module, x: torch.Tensor, *, decode: bool = False) -> torch.Tensor:
    """This rank's rows of a global batch ``x`` (dim 0 split evenly over
    ``data``, as the train step splits a microbatch); ``x`` itself for an
    unsharded model or a mesh of one data rank.  A batch that does not
    split evenly is replicated (every data rank takes all of it, as the
    reference's ``batch_shardings`` leaves it), and so is the batch of a
    decode step (``decode=True``) of a model sharded with
    ``decode_weight_stationary`` (the reference's ``tok_sh`` under
    ``par_act``)."""
    if not is_sharded(model):
        return x
    mesh, par = model._sharding
    dim = mesh.mesh_dim_names.index(par.data_axis)
    n = mesh.size(dim)
    if n == 1 or x.shape[0] % n or (decode and par.decode_weight_stationary):
        return x
    per = x.shape[0] // n
    return x[mesh.get_local_rank(dim) * per:(mesh.get_local_rank(dim) + 1) * per]


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
    d = mesh.size(names.index(par.data_axis))
    if par.decode_weight_stationary and model.cfg.d_model % d:
        raise ValueError(f"a weight-stationary decode splits embed ({model.cfg.d_model}) over {d} data ranks")
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
        chunk = local_chunk(p.detach(), mesh, pl)
        if chunk.untyped_storage().nbytes() != chunk.numel() * chunk.element_size() or not chunk.is_contiguous():
            chunk = chunk.clone(memory_format=torch.contiguous_format)  # its own storage, not the whole's
        shard_ = wrap(chunk, (mesh, dims))
        sub._parameters[attr] = nn.Parameter(shard_, requires_grad=p.requires_grad)
        whole = attr not in LOCAL_WEIGHTS.get(type(sub).__name__, ())
        key = name.split(".")[1] if name.startswith("stack.") else ""
        units.setdefault(key, []).append(_Slot(sub, attr, dims[data_i], dims[model_i], whole,
                                               attr in WS_GATHERED.get(type(sub).__name__, ())))
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


def _reduce_groups(mesh, axes) -> list:
    """The process groups :func:`seq_reduce` runs its all-reduces over for
    the mesh axes ``axes``: the world's (None) where they span the whole
    mesh and world, else each axis of more than one rank's."""
    live = [a for a in axes if mesh.size(mesh.mesh_dim_names.index(a)) > 1]
    if len(live) > 1 and set(axes) == set(mesh.mesh_dim_names) and mesh.size() == dist.get_world_size():
        return [None]
    return [mesh.get_group(mesh.mesh_dim_names.index(a)) for a in live]


def decode_collectives(model: nn.Module, caches=None, batch: Optional[int] = None) -> dict:
    """The collectives one decode step of a sharded ``model`` launches, by
    kind, as the units and the layers schedule them; a prefill launches the
    same as a decode step that gathers (each is one forward pass without a
    backward).  Each unit's gather per dtype (over ``data`` for its FSDP
    shards, none of them but the ``ws_gather`` ones in a weight-stationary
    step; over ``model`` for the weights its layer takes whole); each layer
    on model shards its ``model_sum``; the MoE's two data sums (the dropped
    count and the aux statistics) when its batch splits over ``data``; the
    embedding's ``model_sum`` and the logits' gather over ``model`` when the
    vocab is sharded.  A weight-stationary step over ``data`` adds each
    norm's, each input projection's (the MoE's router and experts: two) and
    the head's data sum, and the sLSTM's gather of the stream.  With the
    step's ``caches`` (and ``batch``, its rows): a sequence-sharded
    attention layer's gather of q over ``model`` and its three reductions
    over the slots' axes; a weight-stationary mixer whose state holds its
    data shard's rows gathers its outputs over ``data``."""
    from repro_torch.models.blocks import SELF_CONTAINED
    from repro_torch.models.layers.attention import SeqKVCache

    mesh, par = model._sharding
    names = mesh.mesh_dim_names
    d, m = mesh.size(names.index(par.data_axis)), mesh.size(names.index(par.model_axis))
    stationary = par.decode_weight_stationary
    ws_d = stationary and d > 1
    cfg = model.cfg
    out = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}

    def unit(module):
        slots = module._shard_unit.slots
        dtypes = lambda pick: len({s.module._parameters[s.attr].dtype for s in slots if pick(s)})  # noqa: E731
        if d > 1:
            out["all_gather"] += dtypes(lambda s: s.data_dim is not None and (s.ws_gather or not stationary))
        if m > 1:
            out["all_gather"] += dtypes(lambda s: s.gather_model and s.model_dim is not None)

    for block, cache in zip(model.stack, caches or [None] * len(model.stack), strict=True):
        unit(block)
        if ws_d:
            out["all_reduce"] += 1 if block.kind in SELF_CONTAINED else 2  # the norms
        for layer in block.modules():
            kind = type(layer).__name__
            if m > 1 and (
                (kind == "Attention" and local(layer.wq).shape[1] != cfg.num_heads)
                or (kind == "MLP" and local(layer.wo).shape[0] != layer.d_ff)
                or (kind == "SpectralMixer" and local(layer.w_in).shape[1] != layer.d_model)
                or (kind == "MoE" and local(layer.wi_gate).shape[0] != cfg.num_experts)
            ):
                out["all_reduce"] += 1
            if kind == "MoE" and d > 1 and not stationary:
                out["all_reduce"] += 2
            if ws_d:
                out["all_reduce"] += {"Attention": 1, "MLP": 1, "SpectralMixer": 1, "Mamba2": 1, "MLSTM": 1,
                                      "MoE": 2}.get(kind, 0)
                out["all_gather"] += kind == "SLSTM"
            if kind == "Attention" and isinstance(cache, SeqKVCache):
                out["all_gather"] += m > 1 and local(layer.wq).shape[1] != cfg.num_heads
                out["all_reduce"] += 3 * len(_reduce_groups(mesh, cache.axes))
            elif layer is getattr(block, "mixer", None) and ws_d and cache is not None and batch \
                    and next(t for t in cache if torch.is_tensor(t)).shape[0] != batch:
                out["all_gather"] += 1  # its data shard's rows of the state: the outputs gathered
    unit(model)
    if m > 1 and local(model.embed.table).shape[0] != cfg.vocab_size:
        out["all_reduce"] += 1
    if ws_d:
        out["all_reduce"] += 2  # the final norm, the head
    head_sharded = (local(model.embed.table).shape[0] if cfg.tie_embeddings
                    else local(model.head.w).shape[1]) != cfg.vocab_size
    if m > 1 and head_sharded:
        out["all_gather"] += 1
    return {k: int(v) for k, v in out.items() if v}
