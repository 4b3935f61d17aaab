"""Sampling: greedy / temperature / top-k / top-p over final logits.

Port of ``repro/serving/sampling.py``.  ``top_k`` and ``top_p`` share one
mechanism: a per-row cutoff logit, everything strictly below it masked to
−∞ (:func:`_mask_below`).  top-k's cutoff is the k-th largest logit; top-p's
(nucleus) is the smallest logit whose inclusion is still needed to reach
cumulative probability ``top_p`` (so at least one token survives).  Both
compose: k first, then p over what k kept.

The draw is Gumbel-max (the argmax of the logits plus Gumbel noise), the
same law as the reference's categorical draw, from an explicit
``torch.Generator``; the random stream cannot equal JAX's.  It reads
nothing back to the host.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sample"]

NEG_INF = -1e30


def _mask_below(logits: torch.Tensor, cutoff: torch.Tensor) -> torch.Tensor:
    """Mask logits strictly below the per-row ``cutoff`` (..., 1) to −∞."""
    return torch.where(logits < cutoff, NEG_INF, logits)


def _nucleus_cutoff(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Per-row nucleus cutoff: keep the smallest set of top tokens whose
    probability mass reaches ``top_p``.  A token is kept while the mass of
    strictly better tokens is still < top_p — the argmax always is."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    mass_before = torch.cumsum(probs, dim=-1) - probs
    kept = (mass_before < top_p).sum(-1, keepdim=True)  # ≥ 1 per row
    return torch.gather(sorted_desc, -1, kept - 1)


def sample(logits: torch.Tensor, *, temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits: (B, V) float32 → (B,) int64 token ids; greedy (the first
    maximum) at ``temperature`` ≤ 0."""
    if temperature <= 0.0:
        return logits.argmax(-1)
    logits = logits / temperature
    if top_k:
        logits = _mask_below(logits, torch.topk(logits, top_k, dim=-1).values[..., -1:])
    if top_p and top_p < 1.0:
        logits = _mask_below(logits, _nucleus_cutoff(logits, top_p))
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    return (logits + gumbel).argmax(-1)
