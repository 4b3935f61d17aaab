"""Trace cost analyzer: flops, bytes, collectives, launches and peak memory
of one call of the port, counted as it runs on fake tensors.

Counterpart of the reference's HLO walk (``src/repro/analysis/hlo.py``).
The reference lowers a cell and reads XLA's optimized HLO; the port has no
compiler between its Python and the card, so :func:`analyze` runs the
cell's real function once, on ``FakeTensor``s under the caller's
``FakeTensorMode`` (:mod:`repro_torch.core.fake`), and counts every op the
dispatcher sees:

* ``dot_flops`` (by dtype): ``torch.utils.flop_counter``'s formulas for
  ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and the convolutions (an
  ``einsum`` or ``matmul`` reaches them);
* one flop per output element of every other computing op (views,
  factories, copies, gathers and scatters compute nothing);
* ``bytes``: each op's input and output bytes (a view moves nothing; an
  in-place write into part of a buffer, a decode step's KV slot, moves
  its update and indices, as the reference counts a
  ``dynamic-update-slice``).  Eager PyTorch fuses nothing, so this is the
  port's real device traffic, up to what the L2 cache catches;
* collectives by kind (``c10d``'s ops, where ``repro_torch.sharding.shard``
  and ``repro_torch.core.distributed`` issue them), with the bytes of each
  one's result per rank, as the reference counts them;
* kernel launches by name (each wrapper's fake branch reports its launch,
  and counts it in ``repro_torch.core.fake.LAUNCHES``, not in the kernel
  module's ``COUNTS`` of real launches):
  each one's bytes as ``chip_smoke.py``'s bound counts them (every input,
  LUT and output once) and its flops (5·f·log2 f per length-f transform,
  6 per twiddle or phasor, 16 per recombined bin);
* ``peak_memory_bytes``: the most device bytes live at once, from every
  storage the call creates and frees (the arguments' storages live from the
  start), the kernels' scratch included.

A Python loop runs and is counted, so ``unknown_trip_loops`` is always 0.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Dict

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.core import fake

__all__ = ["TraceCost", "analyze", "trace", "kernel_cost", "live_tensors"]

#: Ops that compute nothing: they allocate, copy, move or index data.
_NO_FLOPS = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "zeros", "zeros_like",
    "new_zeros", "ones", "ones_like", "new_ones", "full", "full_like", "new_full", "fill", "fill_",
    "zero_", "arange", "scalar_tensor", "lift_fresh", "lift_fresh_copy", "copy", "copy_", "_to_copy",
    "clone", "cat", "stack", "index", "index_select", "gather", "index_put", "index_put_",
    "index_copy", "index_copy_", "scatter", "scatter_", "slice_scatter", "select_scatter",
    "constant_pad_nd", "repeat", "repeat_interleave", "flip", "roll", "_unsafe_view",
    "_local_scalar_dense", "masked_fill", "masked_fill_", "tril", "triu", "detach", "split_with_sizes",
    "embedding", "embedding_dense_backward", "_reshape_copy", "as_strided_scatter", "alias",
    "expand_copy", "permute_copy", "t_copy", "transpose_copy", "view_copy", "unsqueeze_copy",
    "squeeze_copy", "resize_", "set_",
}
#: In-place writes of an update into part of a buffer: they move the update
#: (read, and written into place) and the indices, not the buffer.
_SCATTER_INPLACE = {"index_put_", "index_copy_", "scatter_", "scatter_add_", "index_add_", "masked_scatter_"}
#: Factories that write nothing.
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "lift_fresh",
             "detach", "alias", "_local_scalar_dense", "resize_", "set_"}
_COLLECTIVES = (("allreduce", "all_reduce"), ("reduce_scatter", "reduce_scatter"),
                ("allgather", "all_gather"), ("alltoall", "all_to_all"), ("broadcast", "broadcast"))


@dataclasses.dataclass
class TraceCost:
    """Per-rank cost of one traced call; the reference's ``HloCost`` fields
    and the port's own."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_type: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_ops: float = 0.0
    dot_flops: float = 0.0
    unknown_trip_loops: int = 0
    #: dot flops by the dtype of their inputs ("bfloat16", "float32", ...)
    dot_flops_by_dtype: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: dot flops by op ("mm", "bmm", ...)
    dot_flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: collectives launched by kind
    collective_count_by_type: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: kernel launches by name, and their bytes and flops
    launches: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_bytes: float = 0.0
    kernel_flops: float = 0.0
    #: eager ops dispatched
    ops: float = 0.0
    #: the most device bytes live at once (not scaled, the larger of two kept by ``add``)
    peak_memory_bytes: int = 0
    #: the bytes live when the call began (its arguments')
    argument_bytes: int = 0

    _ADDITIVE = ("flops", "bytes", "collective_bytes", "collective_ops", "dot_flops", "kernel_bytes",
                 "kernel_flops", "ops")
    _MAPS = ("collective_by_type", "dot_flops_by_dtype", "dot_flops_by_op", "collective_count_by_type", "launches")

    def scaled(self, k: float) -> "TraceCost":
        """The cost of ``k`` calls one after another (the peak is one call's)."""
        out = dataclasses.replace(self)
        for f in self._ADDITIVE:
            setattr(out, f, getattr(self, f) * k)
        for f in self._MAPS:
            setattr(out, f, {t: v * k for t, v in getattr(self, f).items()})
        return out

    def add(self, other: "TraceCost") -> None:
        """Add the cost of ``other``, run after this one."""
        for f in self._ADDITIVE:
            setattr(self, f, getattr(self, f) + getattr(other, f))
        for f in self._MAPS:
            mine = getattr(self, f)
            for t, v in getattr(other, f).items():
                mine[t] = mine.get(t, 0.0) + v
        self.unknown_trip_loops += other.unknown_trip_loops
        self.peak_memory_bytes = max(self.peak_memory_bytes, other.peak_memory_bytes)
        self.argument_bytes = max(self.argument_bytes, other.argument_bytes)

    def flops_by_dtype(self) -> Dict[str, float]:
        """Every flop by the peak it runs at: dot flops by their dtype, the
        rest (elementwise work and the FFT kernels) on the fp32 cores."""
        out = dict(self.dot_flops_by_dtype)
        out["float32"] = out.get("float32", 0.0) + self.flops - self.dot_flops
        return out


def _fft_flops(f: int) -> float:
    return 5 * f * math.log2(f) if f > 1 else 0.0


def kernel_cost(name: str, inputs, outputs, kw: dict) -> tuple:
    """(bytes, flops) of one kernel launch, as ``chip_smoke.py``'s bound
    counts them: every input plane and LUT read once and every output
    written once (``bluestein_elem``'s ``post`` reads only the n bins it
    keeps); 5·f·log2 f flops per length-f transform, 6 per twiddle or
    phasor multiply, 16 per recombined bin."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    x, y = inputs[0], outputs[0]
    if name in ("dft_matmul", "fft4step"):
        b, n = x.shape
        return nbytes, b * _fft_flops(n) + (6 * b * n if kw.get("twiddle") else 0)
    if name == "cols_pass":
        r, f, s = x.shape
        return nbytes, r * s * _fft_flops(f) + (6 * r * f * s if kw.get("twiddle") else 0)
    if name == "cols_natural":
        b, pp, f, w = x.shape
        return nbytes, b * pp * w * _fft_flops(f)
    if name == "rows_natural":
        b, pp, f = x.shape
        return nbytes, b * pp * _fft_flops(f)
    if name in ("rfft_recomb", "irfft_recomb"):
        return nbytes, 16 * y.numel()
    if name == "bluestein_elem":
        b, w_in = x.shape
        w_out = y.shape[1]
        keep = 8 * b * min(w_in, w_out)
        return nbytes - 8 * b * w_in + keep, 6 * b * min(w_in, w_out)
    b = x.shape[0]
    n, m = kw["n"], kw["m_pad"]
    per = 6 * n + _fft_flops(m) + 6 * m if name == "bluestein_fwd" else _fft_flops(m) + 6 * n
    return nbytes, b * per


def live_tensors(*objs):
    """Every tensor reachable from ``objs``: tensors, the parameters and
    buffers of modules (a ``DTensor``'s local tensor), and the contents of
    dicts, lists, tuples and named tuples."""
    from torch.distributed.tensor import DTensor

    out, seen = [], set()

    def walk(o):
        if id(o) in seen:
            return
        seen.add(id(o))
        if isinstance(o, DTensor):
            out.append(o.to_local())
        elif isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, nn.Module):
            for t in (*o.parameters(), *o.buffers()):
                walk(t)
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)

    for o in objs:
        walk(o)
    return out


class _Counter(TorchDispatchMode):
    def __init__(self, cost: TraceCost):
        super().__init__()
        self.cost = cost
        self.live: Dict[int, int] = {}
        self.now = 0

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live until it is freed (once per storage)."""
        if t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return
        nbytes = st.nbytes()
        self.live[key] = nbytes
        self.now += nbytes
        self.cost.peak_memory_bytes = max(self.cost.peak_memory_bytes, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.cost
        name = func._overloadpacket.__name__
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if func.namespace == "c10d":
            # The port's collectives take the result buffer first: the
            # all-reduce's tensor (in place), the gather's, the scatter's and
            # the all-to-all's output.
            kind = next((k for tag, k in _COLLECTIVES if tag in name), name)
            nbytes = ins[0].numel() * ins[0].element_size() if ins else 0
            c.collective_bytes += nbytes
            c.collective_by_type[kind] = c.collective_by_type.get(kind, 0.0) + nbytes
            c.collective_count_by_type[kind] = c.collective_count_by_type.get(kind, 0.0) + 1
            c.collective_ops += 1
            return out
        if not outs:  # a query (a device, a size, a scalar read): no data moves
            return out
        c.ops += 1
        for t in outs:
            self.track(t)
        packet = func._overloadpacket
        if packet in flop_registry:
            n = float(flop_registry[packet](*args, **kwargs, out_val=out))
            c.dot_flops += n
            c.flops += n
            dt = str(ins[0].dtype).replace("torch.", "") if ins else "float32"
            c.dot_flops_by_dtype[dt] = c.dot_flops_by_dtype.get(dt, 0.0) + n
            c.dot_flops_by_op[name] = c.dot_flops_by_op.get(name, 0.0) + n
        elif name not in _NO_FLOPS and not func.is_view:
            c.flops += float(sum(t.numel() for t in outs))
        if name in _SCATTER_INPLACE:  # (buffer, ..., indices, update): the update read and written
            c.bytes += float(sum(t.numel() * t.element_size() for t in ins[1:]) + ins[-1].numel() * ins[-1].element_size())
        elif not func.is_view and name not in _NO_BYTES:
            c.bytes += float(sum(t.numel() * t.element_size() for t in (*ins, *outs)))
        return out


def trace(fn, *args, _live=(), **kwargs):
    """(``fn(*args, **kwargs)``, its :class:`TraceCost`), run under the
    caller's fake mode (raises without one: the trace computes nothing).
    The arguments' storages, and those of ``_live`` (what else the caller
    holds on the device: a model, a train state), count as live from the
    start."""
    if not fake.active():
        raise RuntimeError("analyze() runs a call on fake tensors: enter a FakeTensorMode first")
    from repro_torch import kernels

    cost = TraceCost()
    counter = _Counter(cost)
    for t in live_tensors(args, kwargs, _live):
        counter.track(t)
    cost.argument_bytes = counter.now

    def sink(name, inputs, outputs, kw):
        nbytes, flops = kernel_cost(name, inputs, outputs, kw)
        cost.launches[name] = cost.launches.get(name, 0.0) + 1
        cost.kernel_bytes += nbytes
        cost.kernel_flops += flops
        cost.bytes += nbytes
        cost.flops += flops

    before, traced = kernels.counts(), dict(fake.LAUNCHES)
    prev = fake.set_sink(sink)
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        fake.set_sink(prev)
    real = {k: v - before[k] for k, v in kernels.counts().items() if v != before[k]}
    if real:
        raise RuntimeError(f"a traced call launched or ran a kernel's plain version for real: {real}")
    delta = {k: v - traced.get(k, 0) for k, v in fake.LAUNCHES.items() if v != traced.get(k, 0)}
    if delta != {k: int(v) for k, v in cost.launches.items()}:
        raise RuntimeError(f"traced launches {delta} differ from the trace's {cost.launches}")
    return out, cost


def analyze(fn, *args, **kwargs) -> TraceCost:
    """The :class:`TraceCost` of one call ``fn(*args, **kwargs)`` on fake
    tensors (the counterpart of the reference's ``analyze(hlo_text)``)."""
    return trace(fn, *args, **kwargs)[1]
