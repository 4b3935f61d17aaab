"""Int8 gradient compression with error feedback.

Port of ``repro/train/compression.py``.  Each gradient is quantised to
int8 with one scale per reference leaf (a layer parameter together with its
repeats, as the reference's scanned stack holds it:
:func:`repro_torch.utils.params.reference_leaves`), and the quantisation
residual is carried into the next step (error feedback; Seide et al. 2014,
Karimireddy et al. 2019).  The dequantised values are what a data-parallel
all-reduce would move; the residuals are checkpointed with the optimizer's
state.  A sharded model's gradients are its parameters' local shards: a
leaf's scale is the max-abs over the whole leaf (a max over every rank),
and its residual is a shard of the leaf's layout.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding import shard
from repro_torch.utils.params import reference_leaves

__all__ = ["init_error_state", "compress_grads", "quantize_int8", "dequantize_int8"]


def quantize_int8(x: torch.Tensor, amax=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 of ``x`` and its scale, from ``x``'s max-abs or the given
    ``amax`` (a sharded leaf's, over all its shards)."""
    amax = (x.abs().max() if amax is None else amax) + 1e-12
    scale = amax / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(model) -> dict:
    """A zero float32 residual per reference leaf, in its stacked shape."""
    params = dict(model.named_parameters())
    out = {}
    for leaf, (stacked, names) in reference_leaves(model).items():
        p = params[names[0]]
        shape = ((len(names),) if stacked else ()) + tuple(shard.local(p).shape)
        out[leaf] = shard.wrap(torch.zeros(shape, device=p.device), shard.layout(p, stacked))
    return out


@torch.no_grad()
def compress_grads(grads: dict, err_state: dict, model) -> tuple:
    """(the dequantised gradients to feed the optimizer, the new error
    state): per reference leaf, q = int8(g + e) and e' = g + e − deq(q)."""
    out, new_err = {}, {}
    leaves = reference_leaves(model)
    g32 = {}
    for leaf, (stacked, names) in leaves.items():
        g = torch.stack([grads[n].float() for n in names]) if stacked else grads[names[0]].float()
        g32[leaf] = g + shard.local(err_state[leaf])
    amax = [None] * len(leaves)
    if shard.is_sharded(model):  # every leaf's max over its shards: one all-reduce
        amax = shard.world_reduce(torch.stack([g.abs().max() for g in g32.values()]), dist.ReduceOp.MAX)
    for (leaf, (stacked, names)), top in zip(leaves.items(), amax):
        deq = dequantize_int8(*quantize_int8(g32[leaf], top))
        new_err[leaf] = shard.wrap(g32[leaf] - deq, shard.layout(err_state[leaf]))
        for i, name in enumerate(names):
            out[name] = deq[i] if stacked else deq
    return out, new_err
