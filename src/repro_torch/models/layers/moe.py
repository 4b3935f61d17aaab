"""Mixture-of-Experts layer: top-k routing, shared experts, dense residual.

Port of ``repro/models/layers/moe.py`` as an ``nn.Module``, decision for
decision: one group per batch row with ``_capacity(S, cfg)`` slots per
expert, the router in float32 and a softmax, the top k in descending
probability (ties to the lower expert index, as ``lax.top_k``), the weights
normalised, each assignment's slot from the cumulative sum of the one-hot
over the row's (token, choice) order, overflow dropped, the expert FFN as
batched products over (E, G·C, D) with each weight cast to the activation's
dtype at its use, the gather weighted by ``w·keep``, then the shared experts
and the dense residual on the undispatched input, and the Switch
load-balance aux loss.

The reference computes all of it in XLA, outside any Pallas kernel, so this
is plain PyTorch.  One deliberate difference: kept slots are unique, so the
dispatch writes them with ``index_copy`` (no atomics on the card) into the
expert-major (E, G·C, D) buffer directly, and a dropped assignment goes to a
spare last row that is cut off, where the reference adds a zeroed
contribution into its slot.  The outputs are the same.

In a sharded model the experts lie over ``model`` (the rules' ``experts``)
and the tokens are replicated over it (the batch is over ``data`` only):
every model rank routes the same tokens, dispatches the assignments to its
own experts into its (E/m, B·C, D) slice of the buffer, runs them, and the
ranks' combines meet in ``model_sum`` — no all-to-all.  The input and the
routing weights enter the expert shards through ``model_copy``.  The
load-balance statistics and the dropped count are summed over ``data``
first, so the aux term is the global batch's, as the reference's.  Under a
weight-stationary decode the router and the experts' ``wi_*`` contract
this rank's ``embed`` slice and sum over ``data``, ``wo`` gives the
slice, and the batch, replicated over ``data``, needs no data sums.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.models.layers.mlp import ACTIVATIONS, MLP
from repro_torch.sharding.logical import data_shard_count
from repro_torch.sharding.shard import data_sum, data_sum_all, model_copy, model_sum, tp, ws, ws_in
from repro_torch.utils.params import normal

__all__ = ["MoE", "Routing"]


def _capacity(tokens: int, cfg) -> int:
    """Slots per expert in a row of ``tokens``: ``tokens·k·capacity_factor/E``
    aligned up to 8 and clamped to ``tokens·k`` (the reference's own)."""
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    cap = max(8, (cap + 7) // 8 * 8)
    return min(cap, tokens * cfg.top_k)


class Routing(NamedTuple):
    """One call's routing decisions, rows as the groups."""

    probs: torch.Tensor  # (B, S, E) float32, the router's softmax
    weights: torch.Tensor  # (B, S, k) float32, the top k normalised
    idx: torch.Tensor  # (B, S, k) int64 experts, descending probability
    onehot: torch.Tensor  # (B, E, S·k) bool, expert-major: each (token, choice)'s expert
    pos: torch.Tensor  # (B, S·k) int64, its place in its expert's queue
    keep: torch.Tensor  # (B, S·k) bool, pos < capacity
    capacity: int


class MoE(nn.Module):
    """Parameters ``router`` (D, E) in float32 at 0.02, ``wi_gate`` and
    ``wi_up`` (E, D, F) at D^-½, ``wo`` (E, F, D) at F^-½, ``shared`` (an
    :class:`MLP` of width F·num_shared_experts) where the config has shared
    experts and ``dense`` (an :class:`MLP` of width F) where it sets
    ``moe_dense_residual``.

    ``dropped`` is the count of (token, choice) assignments the last call
    dropped, a 0-d int64 tensor on the layer's device (read without a host
    sync until someone asks for its value)."""

    def __init__(self, cfg, *, dtype=torch.float32, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.cfg = cfg
        self.router = normal((D, E), scale=0.02, dtype=torch.float32, device=device, generator=generator)
        self.wi_gate = normal((E, D, F), scale=D**-0.5, **kw)
        self.wi_up = normal((E, D, F), scale=D**-0.5, **kw)
        self.wo = normal((E, F, D), scale=F**-0.5, **kw)
        if cfg.num_shared_experts:
            self.shared = MLP(D, F * cfg.num_shared_experts, act=cfg.act, **kw)
        if cfg.moe_dense_residual:
            self.dense = MLP(D, F, act=cfg.act, **kw)
        self.dropped: Optional[torch.Tensor] = None

    def route(self, x: torch.Tensor) -> Routing:
        """x (B, S, D) → its :class:`Routing`: the router in float32, the top
        k in descending probability with ties to the lower expert index
        (a stable sort: ``torch.topk`` promises no order for ties), and each
        assignment's place from the cumulative one-hot over the row's
        (token, choice) order."""
        b, s, _ = x.shape
        e, k = self.cfg.num_experts, self.cfg.top_k
        probs = torch.softmax(ws_in(x.float(), self.router)[0], dim=-1)
        top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        top, idx = top[..., :k], idx[..., :k]
        flat_e = idx.reshape(b, s * k)
        # Expert-major, so the running count is a scan along the innermost
        # axis (a scan down the outer axis of a (B, S·k, E) one-hot runs one
        # thread per expert on the card).
        onehot = torch.arange(e, device=x.device)[:, None] == flat_e[:, None, :]
        pos = onehot.cumsum(-1).gather(1, flat_e[:, None, :])[:, 0] - 1
        cap = _capacity(s, self.cfg)
        return Routing(probs, top / (top.sum(-1, keepdim=True) + 1e-9), idx, onehot, pos, pos < cap, cap)

    def _experts_here(self) -> Tuple[int, int]:
        """(the first expert this rank holds, how many): all of them
        unsharded."""
        e = self.wi_gate.shape[0]
        return (0, e) if e == self.cfg.num_experts else (tp().rank * e, e)

    def dispatch(self, x: torch.Tensor, r: Routing) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Each kept (token, choice) of x (B, S, D) to one of this rank's
        experts copied to its slot: the expert-major buffer (E_here, B·cap,
        D), every assignment's row in it (B, S·k), a dropped or another
        rank's one's clamped, and which assignments it holds (B, S·k)."""
        b, s, d = x.shape
        k, cap = self.cfg.top_k, r.capacity
        e0, e = self._experts_here()
        at, mine = r.idx.reshape(b, s * k), r.keep
        if e != self.cfg.num_experts:  # this rank's experts only
            at = at - e0
            mine = mine & (at >= 0) & (at < e)
            at = at.clamp(0, e - 1)
        rows = at * (b * cap) + torch.arange(b, device=x.device)[:, None] * cap
        rows = rows + r.pos.clamp(max=cap - 1)
        # A dropped assignment writes the spare last row, which is cut off.
        spare = e * b * cap
        dest = torch.where(mine, rows, spare).reshape(-1)
        contrib = x[:, :, None].expand(b, s, k, d).reshape(b * s * k, d)
        h = x.new_zeros(spare + 1, d).index_copy(0, dest, contrib)[:spare].view(e, b * cap, d)
        return h, rows, mine

    def experts(self, h: torch.Tensor) -> torch.Tensor:
        """The expert FFN over the buffer (E, C, D), each weight cast to the
        buffer's dtype at its use."""
        cd = h.dtype
        gate, up = torch.bmm(h, self.wi_gate.to(cd)), torch.bmm(h, self.wi_up.to(cd))
        if ws():
            gate, up = data_sum_all(gate, up)
        act = ACTIVATIONS[self.cfg.act](gate) * up
        return torch.bmm(act, self.wo.to(cd))

    def combine(self, y_e: torch.Tensor, rows: torch.Tensor, mine: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
        """Each held assignment's expert output gathered back, weighted by
        ``w·keep`` (``weights`` (B, S, k), ``mine`` the held ones) in the
        buffer's dtype and summed over the k choices: (B, S, D)."""
        b, sk = rows.shape
        k, d = self.cfg.top_k, y_e.shape[-1]
        y_tok = y_e.reshape(-1, d).index_select(0, rows.reshape(-1)).view(b, sk, d)
        w = (weights.reshape(b, sk) * mine.float()).to(y_e.dtype)
        return (y_tok * w[..., None]).view(b, sk // k, k, d).sum(2)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, D) → (y (B, S, D) in x's dtype, aux loss, float32 0-d)."""
        cfg = self.cfg
        r = self.route(x)
        sharded = self.wi_gate.shape[0] != cfg.num_experts
        replicated = ws()  # a weight-stationary decode's batch: every row on every data rank
        self.dropped = (~r.keep).sum() if replicated else data_sum((~r.keep).sum())
        if sharded:
            xe, we = model_copy(x), model_copy(r.weights)
        else:
            xe, we = x, r.weights
        h, rows, mine = self.dispatch(xe, r)
        y = self.combine(self.experts(h), rows, mine, we)
        if sharded:
            y = model_sum(y)
        if cfg.num_shared_experts:
            y = y + self.shared(x)
        if cfg.moe_dense_residual:
            y = y + self.dense(x)

        b, s, _ = x.shape
        me = r.probs.mean((0, 1))  # mean router probability per expert
        ce = r.onehot.sum((0, 2)).float() / (b * s)  # assignments per token, dropped ones too
        shards = 1 if replicated else data_shard_count()
        if shards > 1:  # the global batch's means (equal rows per shard)
            me, ce = data_sum(torch.stack([me, ce])) / shards
        return y, (me * ce).sum() * cfg.num_experts * cfg.router_aux_loss
