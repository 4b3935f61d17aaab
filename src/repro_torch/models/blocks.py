"""Residual blocks: one mixer (and an MLP or MoE where the family uses one)
per kind.

Port of ``repro/models/blocks.py``, every kind:

attn          pre-norm global attention + pre-norm MLP
attn_local    same, sliding-window (``cfg.sliding_window``)
moe           pre-norm global attention + pre-norm MoE FFN (:class:`MoE`)
mamba2        pre-norm Mamba2 (:class:`Mamba2`, self-contained, no MLP)
mlstm         pre-norm mLSTM (:class:`MLSTM`, self-contained, no MLP)
slstm         pre-norm sLSTM (:class:`SLSTM`) + pre-norm MLP
shared_attn   built as ``attn``; the stack shares one such block
spectral      pre-norm FFT long-conv mixer (:class:`SpectralMixer`) + pre-norm MLP

``forward`` returns ``(x, cache or None, aux)``, the aux loss a float32 0-d
tensor (the MoE's, else 0); ``decode`` returns ``(x, new_cache)`` and drops
the aux, as the reference's ``block_decode``.  Both take optional M-RoPE ids
(``mrope_positions``), which only the attention kinds read.  The caches are the layers'
own (:class:`KVCache`, also the ``moe`` and ``shared_attn`` kinds';
:class:`SSMCache`, :class:`MLSTMCache`, :class:`SLSTMCache`;
:class:`SpectralStreamCache`, :class:`SpectralCache`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers.mlp import MLP
from repro_torch.models.layers.moe import MoE
from repro_torch.models.layers.norms import RMSNorm
from repro_torch.models.layers.spectral import SpectralMixer, SpectralStreamCache
from repro_torch.models.layers.ssm import Mamba2
from repro_torch.models.layers.xlstm import MLSTM, SLSTM
from repro_torch.runtime import tracing

__all__ = ["Block", "KINDS", "ATTN_KINDS"]

KINDS = ("attn", "attn_local", "moe", "mamba2", "mlstm", "slstm", "shared_attn", "spectral")
#: The kinds whose mixer is attention (their cache a :class:`KVCache`).
ATTN_KINDS = ("attn", "attn_local", "moe", "shared_attn")
#: The recurrent kinds: the mixer alone (mamba2, mlstm) or with an MLP.
RECURRENT = {"mamba2": Mamba2, "mlstm": MLSTM, "slstm": SLSTM}
SELF_CONTAINED = ("mamba2", "mlstm")


def _ff_dim(cfg) -> int:
    return cfg.d_ff if cfg.d_ff > 0 else 2 * cfg.d_model


class Block(nn.Module):
    """Parameters ``norm1.scale``, ``mixer.*``, ``norm2.scale`` and
    ``mlp.*`` (``moe.*`` for the kind ``moe``; ``norm1`` and ``mixer`` only
    for ``mamba2`` and ``mlstm``): the reference's ``block_init`` tree for
    the kind."""

    def __init__(self, kind: str, cfg, *, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}")
        self.kind, self.cfg = kind, cfg
        # The spans of the two branches: block.attn for every attention
        # kind, block.<kind> for the others; block.mlp or block.moe.
        self._mixer_span = "block.attn" if kind in ATTN_KINDS else f"block.{kind}"
        self._ffn_span = "block.moe" if kind == "moe" else "block.mlp"
        d = cfg.d_model
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.norm1 = RMSNorm(d, eps=cfg.norm_eps, device=device)
        if kind == "spectral":
            self.mixer = SpectralMixer(
                d, cfg.spectral_filter_len, decode_chunk=cfg.spectral_decode_chunk,
                decode_mode=cfg.spectral_decode_mode, **kw,
            )
        elif kind in RECURRENT:
            self.mixer = RECURRENT[kind](cfg, **kw)
        else:
            window = cfg.sliding_window if kind == "attn_local" else None
            self.mixer = attn_lib.Attention(cfg, window=window, **kw)
        if kind in SELF_CONTAINED:
            return
        self.norm2 = RMSNorm(d, eps=cfg.norm_eps, device=device)
        if kind == "moe":
            self.moe = MoE(cfg, **kw)
        else:
            self.mlp = MLP(d, _ff_dim(cfg), act=cfg.act, **kw)

    def _ffn(self, x: torch.Tensor):
        """x through the second residual branch, and the MoE's aux loss or
        None; ``mamba2`` and ``mlstm`` have no second branch."""
        if self.kind in SELF_CONTAINED:
            return x, None
        h = self.norm2(x)
        with tracing.span(self._ffn_span):
            if self.kind == "moe":
                y, aux = self.moe(h)
                return x + y, aux
            return x + self.mlp(h), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor, return_cache: bool = False,
                mrope_positions: Optional[torch.Tensor] = None):
        h = self.norm1(x)
        with tracing.span(self._mixer_span):
            if self.kind in ATTN_KINDS:
                res = self.mixer(h, positions, return_cache=return_cache, mrope_positions=mrope_positions)
            else:
                res = self.mixer(h, return_cache=return_cache)
        res, cache = res if return_cache else (res, None)
        x, aux = self._ffn(x + res)
        return x, cache, (x.new_zeros((), dtype=torch.float32) if aux is None else aux)

    def decode(self, x: torch.Tensor, cache, t, mrope_positions: Optional[torch.Tensor] = None):
        """One token, x (B, 1, D), at position ``t`` (an int or (B,)); an
        attention kind rotates by ``mrope_positions`` (B, 3, 1) where given."""
        h = self.norm1(x)
        with tracing.span(self._mixer_span):
            if self.kind in ATTN_KINDS:
                res, cache = self.mixer.decode(h, cache, t, mrope_positions)
            elif isinstance(cache, SpectralStreamCache):
                # Dispatch on the cache's layout, not the config: a prepared
                # cache of either mode decodes (the ring is the exactness oracle).
                res, cache = self.mixer.stream_decode(h, cache)
            else:
                res, cache = self.mixer.decode(h, cache)
        return self._ffn(x + res)[0], cache

    def cache_init(self, batch: int, max_len: int, dtype: torch.dtype):
        """The empty decode state of this layer (the spectral mixer's and the
        recurrent layers' in float32, the Mamba2 conv history in ``dtype``,
        a KV cache in ``dtype`` or int8)."""
        if self.kind == "spectral":
            if self.mixer.decode_mode == "ring":
                return self.mixer.init_cache(batch)
            return self.mixer.init_stream_cache(batch)
        if self.kind == "mamba2":
            return self.mixer.init_cache(batch, dtype)
        if self.kind in RECURRENT:
            return self.mixer.init_cache(batch)
        return self.mixer.cache_init(batch, max_len, dtype, self.norm1.scale.device)
