"""Token embedding and output head.

Port of ``repro/models/layers/embedding.py``: the lookup scaled by
√d_model in the compute dtype, and the head's logits in float32 (tied to
the embedding table or its own ``w``), optionally final-softcapped.  In a
sharded model with the vocab over ``model`` the lookup reads this rank's
rows (the others' tokens masked) and the ranks' rows meet in
``model_sum``; the head's input enters through ``model_copy`` and its
logits are this rank's vocab slice (the loss reduces over ``model``).
Under a weight-stationary decode the table's (vocab/model, D/data) shard
looks up this rank's ``embed`` slice, and the head's (D/data, vocab/model)
shard gives partial logits summed over ``data``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.sharding.shard import data_sum, model_copy, model_sum, tp
from repro_torch.utils.params import cast, normal

__all__ = ["Embedding", "Head"]


class Embedding(nn.Module):
    """``table`` (vocab, d_model), drawn at scale 1."""

    def __init__(self, cfg, *, dtype=torch.float32, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d_model, self.vocab = cfg.d_model, cfg.vocab_size
        self.table = normal((cfg.vocab_size, cfg.d_model), scale=1.0, dtype=dtype, device=device,
                            generator=generator)

    def forward(self, tokens: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
        # gemma-style scale, rounded to the compute dtype first as the
        # reference multiplies by it
        scale = torch.tensor(self.d_model**0.5, dtype=compute_dtype).item()
        rows = self.table.shape[0]
        if rows == self.vocab:
            return self.table[tokens].to(compute_dtype) * scale
        at = tokens - tp().rank * rows
        mine = (at >= 0) & (at < rows)
        x = self.table[at.clamp(0, rows - 1)] * mine[..., None].to(self.table.dtype)
        return model_sum(x.to(compute_dtype)) * scale


class Head(nn.Module):
    """Logits in float32: ``x @ w`` with ``w`` (d_model, vocab), or the
    embedding table's transpose when the config ties them (then this module
    has no parameter, as the reference's empty ``head``)."""

    def __init__(self, cfg, *, dtype=torch.float32, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.tied, self.vocab, self.d_model = cfg.tie_embeddings, cfg.vocab_size, cfg.d_model
        self.softcap = cfg.final_logit_softcap
        if not self.tied:
            self.w = normal((cfg.d_model, cfg.vocab_size), dtype=dtype, device=device, generator=generator)

    def forward(self, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        w = cast(table, torch.float32).T if self.tied else cast(self.w, torch.float32)
        if w.shape[1] != self.vocab:  # this rank's vocab slice
            x = model_copy(x)
        logits = x.float() @ w
        if w.shape[0] != self.d_model:  # this rank's embed slice: partial logits
            logits = data_sum(logits)
        if self.softcap:
            logits = torch.tanh(logits / self.softcap) * self.softcap
        return logits
