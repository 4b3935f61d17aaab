"""Optimizers: AdamW, Adafactor, SGD, and global-norm clipping.

Port of ``repro/train/optimizer.py`` with the reference's math.  Each
optimizer is an ``(init, update)`` pair: ``init(model)`` gives an
:class:`OptState`, ``update(grads, state, model, lr)`` writes the new
parameters into ``model`` in place (in float32, cast back to each
parameter's dtype) and returns the new state.  ``grads`` maps each
parameter name to its (clipped, float32) gradient.

AdamW and SGD are elementwise, so they keep one state tensor per
parameter.  Adafactor reduces over whole tensors (its factored second
moments, its update clipping), so it works on the reference's leaves
(:func:`repro_torch.utils.params.reference_leaves`): a layer parameter is
updated stacked with its repeats, as the reference's scanned stack holds
it, and its statistics keep the reference's stacked shapes.

A sharded model's parameters (``DTensor``, :mod:`repro_torch.sharding`)
take their local gradients: AdamW and SGD update each shard elementwise;
the global norm sums the squares over the shards, each replicated shard
once; Adafactor's means and its update's RMS sum over the shards of the
dims they reduce; its statistics are shards of the same layout, the
reduced dim's sharding dropped.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.sharding import shard
from repro_torch.utils.params import reference_leaves

__all__ = ["make_optimizer", "OptState", "global_norm", "clip_by_global_norm"]


class OptState(NamedTuple):
    step: int
    inner: Any


def global_norm(grads: dict, model=None) -> torch.Tensor:
    """√(Σ ‖g‖²) over every gradient, in float32, as a 0-d tensor.  A
    sharded ``model``'s gradients are its parameters' local shards: the
    squares are summed over every rank, each replicated shard once."""
    if model is None or not shard.is_sharded(model):
        return torch.sqrt(torch.stack([g.float().square().sum() for g in grads.values()]).sum())
    params = dict(model.named_parameters())
    sq = torch.stack([grads[n].float().square().sum() * shard.owned(params[n]) for n in grads]).sum()
    return torch.sqrt(shard.world_reduce(sq))


def clip_by_global_norm(grads: dict, max_norm: float, model=None):
    """Every gradient cast to float32 and scaled by min(1, max/(norm + 1e-9));
    returns (clipped grads, norm).  Nothing is read back to the host."""
    norm = global_norm(grads, model)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g.float() * scale for k, g in grads.items()}, norm


def _f32(x: float) -> float:
    return float(np.float32(x))


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


def _adamw(train_cfg):
    b1, b2, eps, wd = train_cfg.b1, train_cfg.b2, 1e-8, train_cfg.weight_decay

    def init(model):
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for n, p in model.named_parameters()}
        return OptState(step=0, inner={"m": zeros(), "v": zeros()})

    @torch.no_grad()
    def update(grads, state, model, lr):
        t = state.step + 1
        bc1 = _f32(1 - np.float32(b1) ** np.float32(t))
        bc2 = _f32(1 - np.float32(b2) ** np.float32(t))
        for name, p in model.named_parameters():
            g, p = grads[name], shard.local(p)
            m, v = shard.local(state.inner["m"][name]), shard.local(state.inner["v"][name])
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            # Weight decay on every parameter (no mask), eps added to √v̂.
            step = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            step.add_(p.float(), alpha=wd)
            if p.dtype == torch.float32:
                p.sub_(step, alpha=lr)
            else:
                p.copy_(p.float().sub_(step, alpha=lr))
        return OptState(step=t, inner=state.inner)

    return init, update


# --------------------------------------------------------------------------
# Adafactor (factored second moments, no first moment)
# --------------------------------------------------------------------------


def _leaf(tensors: dict, names: tuple, stacked: bool) -> torch.Tensor:
    """One reference leaf of ``tensors`` in float32 (a sharded model's:
    the local shards): its repeats stacked."""
    if stacked:
        return torch.stack([shard.local(tensors[n]).float() for n in names])
    return shard.local(tensors[names[0]]).float()


def _drop(lay, dim: int):
    """Layout ``lay`` of a tensor with dim ``dim`` reduced away."""
    if lay is None:
        return None
    mesh, dims = lay
    return mesh, [None if d is None or d == dim else d - (d > dim) for d in dims]


def _mean(x: torch.Tensor, dims, lay, keepdim: bool = False) -> torch.Tensor:
    """The mean over ``dims`` of the whole tensor of layout ``lay`` whose
    local tensor is ``x`` (``x.mean`` unsharded)."""
    if lay is None:
        return x.mean(dims, keepdim=keepdim)
    total, n = shard.whole_sum(x, dims, lay, keepdim)
    return total / n


def _adafactor(train_cfg):
    eps = 1e-30
    clip_thr = 1.0
    wd = train_cfg.weight_decay
    d2 = train_cfg.b2  # decay of the running statistics

    def init(model):
        inner, params = {}, dict(model.named_parameters())
        for leaf, (stacked, names) in reference_leaves(model).items():
            p = params[names[0]]
            shape = ((len(names),) if stacked else ()) + tuple(shard.local(p).shape)
            lay, dev = shard.layout(p, stacked), p.device
            if len(shape) >= 2:
                inner[leaf] = {"vr": shard.wrap(torch.zeros(shape[:-1], device=dev), _drop(lay, len(shape) - 1)),
                               "vc": shard.wrap(torch.zeros(shape[:-2] + shape[-1:], device=dev),
                                                _drop(lay, len(shape) - 2))}
            else:
                inner[leaf] = {"v": shard.wrap(torch.zeros(shape, device=dev), lay)}
        return OptState(step=0, inner=inner)

    @torch.no_grad()
    def update(grads, state, model, lr):
        t = state.step + 1
        beta = min(_f32(1.0 - np.float32(t) ** np.float32(-0.8)), d2)  # the step-dependent decay
        params = dict(model.named_parameters())
        for leaf, (stacked, names) in reference_leaves(model).items():
            p, g, s = _leaf(params, names, stacked), _leaf(grads, names, stacked), state.inner[leaf]
            lay = shard.layout(params[names[0]], stacked)
            g2 = g.square() + eps
            if "vr" in s:
                vr, vc = shard.local(s["vr"]), shard.local(s["vc"])
                vr.mul_(beta).add_(_mean(g2, -1, lay), alpha=1 - beta)
                vc.mul_(beta).add_(_mean(g2, -2, lay), alpha=1 - beta)
                # V ≈ (vr ⊗ vc) / mean(vr)  (Shazeer & Stern eq. 4)
                denom = torch.clamp(_mean(vr, -1, _drop(lay, g.dim() - 1), keepdim=True)[..., None], min=eps)
                u = g * torch.rsqrt(vr[..., None] * vc[..., None, :] / denom + eps)
            else:
                v = shard.local(s["v"])
                v.mul_(beta).add_(g2, alpha=1 - beta)
                u = g * torch.rsqrt(v + eps)
            # update clipping (RMS ≤ 1)
            rms = torch.sqrt(_mean(u.square(), tuple(range(u.dim())), lay) + eps)
            u = u / torch.clamp(rms / clip_thr, min=1.0)
            new = p - lr * (u + wd * p)
            for i, name in enumerate(names):
                shard.local(params[name]).copy_(new[i] if stacked else new)
        return OptState(step=t, inner=state.inner)

    return init, update


def _sgd(train_cfg):
    def init(model):
        return OptState(step=0, inner=())

    @torch.no_grad()
    def update(grads, state, model, lr):
        for name, p in model.named_parameters():
            p = shard.local(p)
            p.copy_(p.float() - lr * grads[name].float())
        return OptState(step=state.step + 1, inner=())

    return init, update


def make_optimizer(train_cfg):
    if train_cfg.optimizer == "adamw":
        return _adamw(train_cfg)
    if train_cfg.optimizer == "adafactor":
        return _adafactor(train_cfg)
    if train_cfg.optimizer == "sgd":
        return _sgd(train_cfg)
    raise ValueError(f"unknown optimizer {train_cfg.optimizer!r}")
