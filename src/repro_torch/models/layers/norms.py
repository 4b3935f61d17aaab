"""Normalisation layers.

Port of ``repro/models/layers/norms.py``: ``rms_norm`` and ``layer_norm``,
and the ``RMSNorm`` module the blocks use (parameter ``scale``, float32 as
the reference initialises it whatever the model's parameter dtype).  On
this rank's ``embed`` slice of a weight-stationary decode's stream the
sum of squares is summed over ``data`` and the scale's slice applies.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.sharding.shard import data_sum, stream_slice

__all__ = ["RMSNorm", "rms_norm", "layer_norm"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # The variance and its rsqrt in float32; the scaling in x's dtype, as
    # the reference does (it keeps the activation out of float32).
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.scale.shape[0]
        if x.shape[-1] == d:
            return rms_norm(x, self.scale, self.eps)
        var = data_sum(x.float().square().sum(-1, keepdim=True)) / d
        inv = torch.rsqrt(var + self.eps).to(x.dtype)
        return x * inv * stream_slice(self.scale).to(x.dtype)

