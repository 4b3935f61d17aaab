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
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.utils.params import reference_leaves

__all__ = ["make_optimizer", "OptState", "global_norm", "clip_by_global_norm"]


class OptState(NamedTuple):
    step: int
    inner: Any


def global_norm(grads: dict) -> torch.Tensor:
    """√(Σ ‖g‖²) over every gradient, in float32, as a 0-d tensor."""
    return torch.sqrt(torch.stack([g.float().square().sum() for g in grads.values()]).sum())


def clip_by_global_norm(grads: dict, max_norm: float):
    """Every gradient cast to float32 and scaled by min(1, max/(norm + 1e-9));
    returns (clipped grads, norm).  Nothing is read back to the host."""
    norm = global_norm(grads)
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
        m, v = state.inner["m"], state.inner["v"]
        for name, p in model.named_parameters():
            g = grads[name]
            m[name].mul_(b1).add_(g, alpha=1 - b1)
            v[name].mul_(b2).addcmul_(g, g, value=1 - b2)
            # Weight decay on every parameter (no mask), eps added to √v̂.
            step = (m[name] / bc1).div_((v[name] / bc2).sqrt_().add_(eps))
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
    """One reference leaf of ``tensors`` in float32: its repeats stacked."""
    return torch.stack([tensors[n].float() for n in names]) if stacked else tensors[names[0]].float()


def _adafactor(train_cfg):
    eps = 1e-30
    clip_thr = 1.0
    wd = train_cfg.weight_decay
    d2 = train_cfg.b2  # decay of the running statistics

    def init(model):
        inner, params = {}, dict(model.named_parameters())
        for leaf, (stacked, names) in reference_leaves(model).items():
            shape = ((len(names),) if stacked else ()) + tuple(params[names[0]].shape)
            dev = params[names[0]].device
            if len(shape) >= 2:
                inner[leaf] = {"vr": torch.zeros(shape[:-1], device=dev),
                               "vc": torch.zeros(shape[:-2] + shape[-1:], device=dev)}
            else:
                inner[leaf] = {"v": torch.zeros(shape, device=dev)}
        return OptState(step=0, inner=inner)

    @torch.no_grad()
    def update(grads, state, model, lr):
        t = state.step + 1
        beta = min(_f32(1.0 - np.float32(t) ** np.float32(-0.8)), d2)  # the step-dependent decay
        params = dict(model.named_parameters())
        for leaf, (stacked, names) in reference_leaves(model).items():
            p, g, s = _leaf(params, names, stacked), _leaf(grads, names, stacked), state.inner[leaf]
            g2 = g.square() + eps
            if "vr" in s:
                s["vr"].mul_(beta).add_(g2.mean(-1), alpha=1 - beta)
                s["vc"].mul_(beta).add_(g2.mean(-2), alpha=1 - beta)
                vr, vc = s["vr"], s["vc"]
                # V ≈ (vr ⊗ vc) / mean(vr)  (Shazeer & Stern eq. 4)
                denom = torch.clamp(vr.mean(-1, keepdim=True)[..., None], min=eps)
                u = g * torch.rsqrt(vr[..., None] * vc[..., None, :] / denom + eps)
            else:
                s["v"].mul_(beta).add_(g2, alpha=1 - beta)
                u = g * torch.rsqrt(s["v"] + eps)
            # update clipping (RMS ≤ 1)
            rms = torch.sqrt(u.square().mean() + eps)
            u = u / torch.clamp(rms / clip_thr, min=1.0)
            new = p - lr * (u + wd * p)
            for i, name in enumerate(names):
                params[name].copy_(new[i] if stacked else new)
        return OptState(step=t, inner=state.inner)

    return init, update


def _sgd(train_cfg):
    def init(model):
        return OptState(step=0, inner=())

    @torch.no_grad()
    def update(grads, state, model, lr):
        for name, p in model.named_parameters():
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
