"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar
memory, strictly recurrent).

Port of ``repro/models/layers/xlstm.py`` as ``nn.Module``s.  The reference
computes both in XLA, outside any Pallas kernel, so this is plain PyTorch,
each weight cast to the activation's dtype at its use as the reference
writes it; the recurrences run in float32.

mLSTM: per head a matrix state C (P × P) and a normaliser n (P), with
exponentially gated updates stabilised by m_t = max(lf_t + m_{t−1}, li_t).
The stabiliser is a max-plus scan; in eager PyTorch it is
``A = cumsum(lf)``, ``m = max(m0 + A, A + cummax(li − A))`` (the
reference's ``lax.associative_scan`` composes the same affine maps in
another order, so the two round differently).  After it the recurrence is
chunked gated linear attention, batched over every chunk as the SSD of
:mod:`repro_torch.models.layers.ssm` (its three-operand contractions taken
two operands at a time, the decay exponent masked before ``exp``), with
only the (C, n) state carried from chunk to chunk.  m0 = 0, as the
reference's (a −1e30 seed would absorb the small decay terms of the float32
cumulative sums).  Decode carries (C, n, m).

sLSTM: per-unit scalar state with recurrent (hidden → gate) weights, a
Python loop over time with the input projection hoisted out of it, as the
reference's ``lax.scan``; m starts at −1e30.

As the reference, an mLSTM sequence longer than ``cfg.chunk_size`` must be
a whole number of chunks (``ValueError`` otherwise).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as tF
from torch import nn

from repro_torch.models.layers.norms import RMSNorm
from repro_torch.models.layers.ssm import carry_chunks, causal_decay, chunks
from repro_torch.sharding.shard import data_gather, own_rows, stream_full, stream_slice, ws_in
from repro_torch.utils.params import cast, normal

__all__ = ["MLSTM", "SLSTM", "MLSTMCache", "SLSTMCache", "stab_scan"]

#: sLSTM's initial stabiliser, the reference's.
M_INIT = -1e30


class MLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, H, P, P)
    n: torch.Tensor  # (B, H, P)
    m: torch.Tensor  # (B, H)


class SLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, D)
    n: torch.Tensor  # (B, D)
    h: torch.Tensor  # (B, D)
    m: torch.Tensor  # (B, D)


def stab_scan(li: torch.Tensor, lf: torch.Tensor, m0: torch.Tensor) -> torch.Tensor:
    """m_t = max(lf_t + m_{t−1}, li_t) over axis 1.  li, lf (B, S, H); m0
    (B, H).  Unrolled, m_t = max(m0 + A_t, max_{s ≤ t}(li_s + A_t − A_s))
    with A the inclusive cumulative sum of lf."""
    a = lf.cumsum(1)
    return torch.maximum(m0[:, None] + a, a + torch.cummax(li - a, dim=1).values)


def gla_chunked(q, k, v, ldecay, b_in, chunk: int):
    """Chunked gated linear attention with a normaliser.  q, k, v (B, S, H,
    P); ldecay, b_in (B, S, H) (log decay, input scale); float32.  Returns
    (cv (B, S, H, P): Σ decayed k vᵀ read by q, nq (B, S, H): the
    normaliser read, (C, n) the final state).  Head-major chunk terms, as
    :func:`~repro_torch.models.layers.ssm.ssd_chunked`'s."""
    bsz, s, h, p = q.shape
    qq, nc = chunks(s, chunk)
    qc, kc, vc = (t.reshape(bsz, nc, qq, h, p).transpose(2, 3) for t in (q, k, v))  # (B, nc, H, Q, P)
    bc = b_in.reshape(bsz, nc, qq, h).transpose(2, 3)  # (B, nc, H, Q)
    cum = ldecay.reshape(bsz, nc, qq, h).transpose(2, 3).cumsum(-1)
    tot = cum[..., -1]
    scores = (qc @ kc.transpose(-1, -2)) * (causal_decay(cum) * bc[..., None, :])  # (B, nc, H, Q, Q)
    cv = scores @ vc
    nq = scores.sum(-1)  # Σ_s M[t, s]·(q_t·k_s)
    wk = (torch.exp(tot[..., None] - cum) * bc)[..., None] * kc
    decay = torch.exp(tot)
    c_starts, c_f = carry_chunks(q.new_zeros((bsz, h, p, p)), decay, wk.transpose(-1, -2) @ vc)
    n_starts, n_f = carry_chunks(q.new_zeros((bsz, h, p)), decay, wk.sum(-2))
    w_q = torch.exp(cum)
    cv = cv + (qc @ c_starts) * w_q[..., None]
    nq = nq + (qc @ n_starts[..., None])[..., 0] * w_q
    return cv.transpose(2, 3).reshape(bsz, s, h, p), nq.transpose(2, 3).reshape(bsz, s, h), (c_f, n_f)


class MLSTM(nn.Module):
    """Parameters as the reference's ``mlstm_init``: ``w_up`` (D, 2·d_inner)
    at fan-in scale, ``w_qkv`` (d_inner, 3·d_inner) at d_inner^-0.5 and
    ``w_down`` (d_inner, D) at d_inner^-0.5 in the parameter dtype; ``w_if``
    (d_inner, 2H) at 0.02, ``b_if`` (2H: 0 for the input gates, linspace(3,
    6) for the forget gates) and ``norm.scale`` in float32."""

    def __init__(self, cfg, *, dtype=torch.float32, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        d_inner, h = cfg.ssm_expand * D, cfg.resolved_ssm_heads
        self.d_inner, self.heads, self.head_dim = d_inner, h, d_inner // h
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.w_up = normal((D, 2 * d_inner), **kw)
        self.w_qkv = normal((d_inner, 3 * d_inner), scale=d_inner**-0.5, **kw)
        self.w_if = normal((d_inner, 2 * h), scale=0.02, device=device, generator=generator)
        self.b_if = nn.Parameter(torch.cat([torch.zeros(h), torch.linspace(3.0, 6.0, h)]).to(device))
        self.norm = RMSNorm(d_inner, eps=cfg.norm_eps, device=device)
        self.w_down = normal((d_inner, D), scale=d_inner**-0.5, **kw)

    def _project(self, x: torch.Tensor):
        """x (B, S, D) → u, z (B, S, d_inner) and q, k, v (B, S, H, P) in
        the compute dtype (k scaled by P^-0.5)."""
        cd, (b, s, _) = x.dtype, x.shape
        d, h, p = self.d_inner, self.heads, self.head_dim
        (up,) = ws_in(x, self.w_up)  # a weight-stationary decode: summed over data
        u, z = up[..., :d], up[..., d:]
        qkv = u @ cast(self.w_qkv, cd)
        q = qkv[..., :d].reshape(b, s, h, p)
        k = qkv[..., d:2 * d].reshape(b, s, h, p) * p**-0.5
        return u, z, q, k, qkv[..., 2 * d:].reshape(b, s, h, p)

    def _gates(self, u: torch.Tensor):
        """Log input and forget gates (B, S, H), float32."""
        gf = u.float() @ self.w_if + self.b_if
        return gf[..., :self.heads], tF.logsigmoid(gf[..., self.heads:])

    def _out(self, out: torch.Tensor, z: torch.Tensor, batch: Optional[int] = None) -> torch.Tensor:
        """The output projection; a weight-stationary decode's data shard of
        the rows gathered to the step's ``batch`` before ``w_down``."""
        cd = z.dtype
        out = self.norm(out.reshape(*z.shape).to(cd)) * tF.silu(z)
        if batch is not None and out.shape[0] != batch:
            out = data_gather(out)
        return out @ cast(self.w_down, cd)

    def forward(self, x: torch.Tensor, return_cache: bool = False):
        """x (B, S, D) → y (B, S, D) [, :class:`MLSTMCache`]."""
        u, z, q, k, v = self._project(x)
        li, lf = self._gates(u)
        m0 = li.new_zeros((x.shape[0], self.heads))
        m = stab_scan(li, lf, m0)
        m_prev = torch.cat([m0[:, None], m[:, :-1]], dim=1)
        cv, nq, (c_f, n_f) = gla_chunked(q.float(), k.float(), v.float(), lf + m_prev - m, torch.exp(li - m),
                                         self.cfg.chunk_size)
        denom = torch.maximum(nq.abs(), torch.exp(-m))  # max(|nᵀq|, e^{−m})
        res = self._out(cv / denom[..., None], z)
        return (res, MLSTMCache(c=c_f, n=n_f, m=m[:, -1])) if return_cache else res

    def init_cache(self, batch: int) -> MLSTMCache:
        dev, h, p = self.b_if.device, self.heads, self.head_dim
        return MLSTMCache(c=torch.zeros(batch, h, p, p, device=dev), n=torch.zeros(batch, h, p, device=dev),
                          m=torch.zeros(batch, h, device=dev))

    def decode(self, x: torch.Tensor, cache: MLSTMCache) -> Tuple[torch.Tensor, MLSTMCache]:
        """One token: x (B, 1, D) → (y (B, 1, D), new cache).  A
        weight-stationary step over a state of its data shard's rows updates
        those rows."""
        u, z, q, k, v = (own_rows(t, cache.m.shape[0]) for t in self._project(x))
        q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
        li, lf = (g[:, 0] for g in self._gates(u))
        m_new = torch.maximum(lf + cache.m, li)
        fdec = torch.exp(lf + cache.m - m_new)
        iin = torch.exp(li - m_new)
        c = cache.c * fdec[..., None, None] + iin[..., None, None] * torch.einsum("bhp,bho->bhpo", k, v)
        n = cache.n * fdec[..., None] + iin[..., None] * k
        cv = torch.einsum("bhp,bhpo->bho", q, c)
        nq = torch.einsum("bhp,bhp->bh", q, n)
        denom = torch.maximum(nq.abs(), torch.exp(-m_new))
        return self._out(cv / denom[..., None], z, x.shape[0]), MLSTMCache(c=c, n=n, m=m_new)


class SLSTM(nn.Module):
    """Parameters as the reference's ``slstm_init``: ``w_x`` (D, 4D) at
    fan-in scale and ``w_h`` (D, 4D) at D^-0.5 (the gates i, f, z, o),
    ``w_out`` (D, D) at D^-0.5 in the parameter dtype; ``bias`` (4D: the
    forget gate's 4, the others 0) and ``norm.scale`` in float32."""

    def __init__(self, cfg, *, dtype=torch.float32, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.w_x = normal((D, 4 * D), **kw)
        self.w_h = normal((D, 4 * D), scale=D**-0.5, **kw)
        self.bias = nn.Parameter(torch.cat([torch.zeros(D), torch.full((D,), 4.0), torch.zeros(2 * D)]).to(device))
        self.norm = RMSNorm(D, eps=cfg.norm_eps, device=device)
        self.w_out = normal((D, D), scale=D**-0.5, **kw)

    def _cell(self, xt: torch.Tensor, state: SLSTMCache, w_h: torch.Tensor) -> SLSTMCache:
        """One step; xt (B, 4D) the input's projection, w_h in float32."""
        c, n, hid, m = state
        d = c.shape[-1]
        g = xt + hid @ w_h + self.bias
        li, lf = g[:, :d], tF.logsigmoid(g[:, d:2 * d])
        zt, ot = torch.tanh(g[:, 2 * d:3 * d]), torch.sigmoid(g[:, 3 * d:])
        m_new = torch.maximum(lf + m, li)
        fdec = torch.exp(lf + m - m_new)
        iin = torch.exp(li - m_new)
        c_new = fdec * c + iin * zt
        n_new = fdec * n + iin
        return SLSTMCache(c=c_new, n=n_new, h=ot * c_new / torch.clamp(n_new.abs(), min=1.0), m=m_new)

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        """The input's contribution to the gates, (..., 4D) float32."""
        return x.float() @ cast(self.w_x, torch.float32)

    def _out(self, hs: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        return self.norm(hs.to(cd)) @ cast(self.w_out, cd)

    def forward(self, x: torch.Tensor, return_cache: bool = False):
        """x (B, S, D) → y (B, S, D) [, :class:`SLSTMCache`]."""
        xg = self._in(x)  # (B, S, 4D), hoisted out of the loop
        state, w_h = self.init_cache(x.shape[0]), cast(self.w_h, torch.float32)
        hs = []
        for t in range(x.shape[1]):
            state = self._cell(xg[:, t], state, w_h)
            hs.append(state.h)
        out = self._out(torch.stack(hs, 1), x.dtype)
        return (out, state) if return_cache else out

    def init_cache(self, batch: int) -> SLSTMCache:
        d, dev = self.cfg.d_model, self.bias.device
        return SLSTMCache(c=torch.zeros(batch, d, device=dev), n=torch.zeros(batch, d, device=dev),
                          h=torch.zeros(batch, d, device=dev), m=torch.full((batch, d), M_INIT, device=dev))

    def decode(self, x: torch.Tensor, cache: SLSTMCache) -> Tuple[torch.Tensor, SLSTMCache]:
        """One token: x (B, 1, D) → (y (B, 1, D), new cache)."""
        # A weight-stationary decode gathers the sLSTM whole, the stream
        # too, and updates its data shard's rows of the state where the
        # state holds only those.
        state = self._cell(self._in(own_rows(stream_full(x)[:, 0], cache.c.shape[0])), cache, cast(self.w_h, torch.float32))
        hs = state.h[:, None] if state.h.shape[0] == x.shape[0] else data_gather(state.h[:, None])
        return stream_slice(self._out(hs, x.dtype)), state
