"""Gated MLP (SwiGLU / GeGLU) and the plain variant.

Port of ``repro/models/layers/mlp.py``.  ``gelu`` is the tanh approximation
(the reference's default gelu); the weights are cast to the activation's dtype
at each use, as the reference writes ``params[...].astype(cd)``.  In a
sharded model with ``ff`` over ``model`` each rank computes its ff shard:
the input enters through ``model_copy`` and the partial outputs meet in
``model_sum`` (the reference's ``ann`` of h and y).  Under a
weight-stationary decode the input is this rank's ``embed`` slice and the
``wi_*`` shards' partial products meet over ``data``
(:func:`~repro_torch.sharding.shard.ws_in`); ``wo``'s (ff, D/data) shard
gives the output's slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as tF
from torch import nn

from repro_torch.sharding.shard import model_copy, model_sum, ws, ws_in
from repro_torch.utils.params import normal

__all__ = ["MLP", "ACTIVATIONS"]

ACTIVATIONS = {
    "silu": tF.silu,
    "gelu": lambda x: tF.gelu(x, approximate="tanh"),
    "relu": tF.relu,
}


class MLP(nn.Module):
    """``act(x @ wi_gate) * (x @ wi_up) @ wo``; ``wi_*`` (d_model, d_ff) at
    fan-in scale, ``wo`` (d_ff, d_model) at d_ff^-0.5."""

    def __init__(self, d_model: int, d_ff: int, *, act: str = "silu", dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if act not in ACTIVATIONS:
            raise ValueError(f"act must be one of {sorted(ACTIVATIONS)}, got {act!r}")
        self.act, self.d_ff = act, d_ff
        self.wi_gate = normal((d_model, d_ff), dtype=dtype, device=device, generator=generator)
        self.wi_up = normal((d_model, d_ff), dtype=dtype, device=device, generator=generator)
        self.wo = normal((d_ff, d_model), scale=d_ff**-0.5, dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = x.dtype
        sharded = self.wo.shape[0] != self.d_ff
        if ws():
            g, u = ws_in(x, self.wi_gate, self.wi_up)
        else:
            if sharded:
                x = model_copy(x)
            g = x @ self.wi_gate.to(cd)
            u = x @ self.wi_up.to(cd)
        y = (ACTIVATIONS[self.act](g) * u) @ self.wo.to(cd)
        return model_sum(y) if sharded else y
