"""The layer stack: one block module per layer, and the shared block.

Port of ``repro/models/stack.py``.  The reference stacks the parameters of
each position of the pattern's repeating unit over the repeats and runs the
stack as one ``lax.scan`` (with checkpointed remat for training); in
eager PyTorch a :class:`Stack` holds the layers in pattern order, layer
``l`` as the submodule ``str(l)``, and runs a Python loop over them.  Every
``shared_attn`` position runs the one block ``shared`` (zamba2's weight
sharing, the reference's unstacked ``stack.shared`` leaf): its parameters
are registered once, as ``stack.shared.<name>``, and the gradient a
training step gives them is the sum over their uses.  Indexing and
iteration give the blocks in pattern order (the shared block at each of
its positions) and ``len`` is the pattern's length.  ``cfg.remat``
checkpoints each block of a forward that builds a graph
(``torch.utils.checkpoint``, non-reentrant): its activations are recomputed
in the backward instead of kept.  The forward sums the blocks' aux losses
(the MoE's load-balance term) as the reference's scan carries them.
Caches are a list with one entry per layer, batch at axis 0 (the
reference's are stacked per unit position, repeats leading).  :func:`find_unit` is the reference's, which
``load_reference_model`` uses to unstack the reference's parameters.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.blocks import Block

__all__ = ["Stack", "find_unit"]


def find_unit(pattern: tuple) -> tuple:
    """The smallest prefix whose repeats make up ``pattern``."""
    n = len(pattern)
    for u in range(1, n + 1):
        if n % u == 0 and tuple(pattern[:u]) * (n // u) == tuple(pattern):
            return tuple(pattern[:u])
    return tuple(pattern)


def _hidden(block, x: torch.Tensor, positions: torch.Tensor, mrope_positions: Optional[torch.Tensor]):
    """A block's (hidden states, aux) without its cache: the checkpointed call."""
    x, _, aux = block(x, positions, mrope_positions=mrope_positions)
    return x, aux


class Stack(nn.Module):
    """``cfg.pattern()``'s blocks, layer ``l`` at index ``l``; the block of
    every ``shared_attn`` layer is ``self.shared`` (drawn at the first such
    layer)."""

    def __init__(self, cfg, *, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pattern = tuple(cfg.pattern())
        for layer, kind in enumerate(self.pattern):
            name = "shared" if kind == "shared_attn" else str(layer)
            if not hasattr(self, name):
                self.add_module(name, Block(kind, cfg, dtype=dtype, device=device, generator=generator))
        self.remat = cfg.remat

    def __len__(self) -> int:
        return len(self.pattern)

    def __getitem__(self, layer: int) -> Block:
        kind = self.pattern[layer]
        return self.shared if kind == "shared_attn" else getattr(self, str(layer % len(self)))

    def __iter__(self) -> Iterator[Block]:
        return (self[layer] for layer in range(len(self)))

    def forward(self, x: torch.Tensor, positions: torch.Tensor, return_cache: bool = False,
                mrope_positions: Optional[torch.Tensor] = None):
        """x: (B, S, D) → (x, per-layer caches or None, Σ aux float32 0-d);
        ``mrope_positions`` (B, 3, S) go to every attention layer."""
        total = x.new_zeros((), dtype=torch.float32)
        if self.remat and torch.is_grad_enabled() and not return_cache:
            for block in self:
                x, aux = checkpoint(_hidden, block, x, positions, mrope_positions, use_reentrant=False)
                total = total + aux
            return x, None, total
        caches = []
        for block in self:
            x, cache, aux = block(x, positions, return_cache=return_cache, mrope_positions=mrope_positions)
            caches.append(cache)
            total = total + aux
        return x, (caches if return_cache else None), total

    def decode(self, x: torch.Tensor, caches: List, t, mrope_positions: Optional[torch.Tensor] = None):
        """One decode step through every layer; returns (x, new caches)."""
        new = []
        for block, cache in zip(self, caches, strict=True):
            x, cache = block.decode(x, cache, t, mrope_positions)
            new.append(cache)
        return x, new

    def cache_init(self, batch: int, max_len: int, dtype: torch.dtype) -> List:
        return [block.cache_init(batch, max_len, dtype) for block in self]
