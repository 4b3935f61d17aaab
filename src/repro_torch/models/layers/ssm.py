"""Mamba2 (SSD) block: chunked matmul form and an O(1) decode state.

Port of ``repro/models/layers/ssm.py`` as an ``nn.Module``: input projection
→ short causal conv (width ``cfg.conv_width``) → SSD scan with a per-head
scalar decay → D skip → gated RMSNorm → output projection.  The reference
computes it in XLA, outside any Pallas kernel, so this is plain PyTorch, the
weights cast to the activation's dtype at each use as the reference writes
``params[...].astype(cd)``; the SSD runs in float32.

The SSD is the reference's chunked form, the same function computed with
fewer launches: the intra-chunk terms and each chunk's own state update are
batched over every chunk at once, and only the (B, H, P, N) state between
chunks is carried, in a loop of two ops a chunk.  Two points of the
reference's chunk body are written differently, with the same forward:

* ``y_intra = einsum("bqk,bqkh,bkhp->bqhp", scores, m, x)`` contracts
  ``scores ⊙ m`` first, so no (B, Q, Q, H, P) tensor is formed;
* the decay exponent ``cum[t] − cum[s]`` is set to −inf above the diagonal
  *before* ``exp``: the reference's ``where(causal, exp(diff), 0)`` takes
  ``exp`` of large positive values there (inf at chunk 256 on a strongly
  decaying input), which the ``where`` hides in the forward but turns into
  0 · inf = NaN in a backward.

As the reference, a sequence longer than ``cfg.chunk_size`` must be a whole
number of chunks (``ValueError`` otherwise, where the reference asserts).

Shapes: d_inner = expand·d_model, H heads of P = d_inner / H, state N =
``cfg.ssm_state``, one group (B and C shared across heads).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tF
from torch import nn

from repro_torch.models.layers.norms import RMSNorm
from repro_torch.sharding.shard import data_gather, own_rows, ws_in
from repro_torch.utils.params import normal

__all__ = ["Mamba2", "SSMCache", "chunks", "causal_decay", "carry_chunks", "ssd_chunked"]


class SSMCache(NamedTuple):
    """Decode state: ``state`` (B, H, P, N) float32; ``conv`` (B, W − 1,
    conv_dim) the last inputs of the causal conv, in the compute dtype."""

    state: torch.Tensor
    conv: torch.Tensor


def _dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    h = cfg.resolved_ssm_heads
    return d_inner, h, d_inner // h, cfg.ssm_state


def chunks(s: int, chunk: int) -> Tuple[int, int]:
    """(chunk length Q, number of chunks) of a length-``s`` sequence: one
    chunk up to ``chunk``, else whole chunks only (the reference's rule)."""
    q = min(chunk, s)
    if s % q:
        raise ValueError(
            f"sequence length {s} is neither at most the chunk size {chunk} nor a multiple of it "
            "(the chunked scan's rule, as the reference's)"
        )
    return q, s // q


def causal_decay(cum: torch.Tensor) -> torch.Tensor:
    """cum (..., Q) inclusive log-decay sums → (..., Q, Q) with
    exp(cum[t] − cum[s]) at s ≤ t and 0 above the diagonal, the exponent
    masked to −inf before ``exp`` (finite gradients)."""
    q = cum.shape[-1]
    diff = cum[..., :, None] - cum[..., None, :]
    causal = torch.ones(q, q, dtype=torch.bool, device=cum.device).tril()
    return diff.masked_fill(~causal, float("-inf")).exp()


def carry_chunks(h0: torch.Tensor, decay: torch.Tensor, own: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The state entering each chunk and the final one: h_{c+1} = h_c ·
    decay[:, c] + own[:, c].  h0 (B, H, ...); decay (B, nc, H); own (B, nc,
    H, ...).  Returns ((B, nc, H, ...), (B, H, ...))."""
    starts, h = [], h0
    pad = (1,) * (own.dim() - 3)
    for c in range(own.shape[1]):
        starts.append(h)
        h = h * decay[:, c].reshape(decay.shape[0], -1, *pad) + own[:, c]
    return torch.stack(starts, 1), h


def ssd_chunked(xh, b_in, c_in, log_a, dt, h0, chunk: int):
    """Chunked SSD.  xh (B, S, H, P); b_in, c_in (B, S, N); log_a, dt (B, S,
    H); h0 (B, H, P, N); all float32.  Per head h_t = exp(log_a_t)·h_{t−1} +
    dt_t·x_t b_tᵀ, y_t = h_t c_t.  Returns (y (B, S, H, P), h_final).  The
    chunk terms are head-major, (B, nc, H, Q, ...), so the (Q, Q) decay
    matrices are contiguous and the products batched matmuls."""
    bsz, s, h, p = xh.shape
    n = b_in.shape[-1]
    q, nc = chunks(s, chunk)
    xc = xh.reshape(bsz, nc, q, h, p).transpose(2, 3)  # (B, nc, H, Q, P)
    bc, cc = b_in.reshape(bsz, nc, 1, q, n), c_in.reshape(bsz, nc, 1, q, n)
    dtc = dt.reshape(bsz, nc, q, h).transpose(2, 3)  # (B, nc, H, Q)
    cum = log_a.reshape(bsz, nc, q, h).transpose(2, 3).cumsum(-1)  # inclusive
    tot = cum[..., -1]  # (B, nc, H)
    # intra: ((C Bᵀ) ⊙ M) X, M[t, s] = e^{cum[t] − cum[s]}·dt[s] for s ≤ t
    scores = cc @ bc.transpose(-1, -2)  # (B, nc, 1, Q, Q)
    y = (scores * (causal_decay(cum) * dtc[..., None, :])) @ xc
    # each chunk's own state: Σ_s e^{tot − cum[s]}·dt[s]·x_s b_sᵀ
    w_s = torch.exp(tot[..., None] - cum) * dtc
    own = (w_s[..., None] * xc).transpose(-1, -2) @ bc  # (B, nc, H, P, N)
    starts, h_final = carry_chunks(h0, torch.exp(tot), own)
    # inter: y[t] += e^{cum[t]} · h_start c_t
    y = y + (cc @ starts.transpose(-1, -2)) * torch.exp(cum)[..., None]
    return y.transpose(2, 3).reshape(bsz, s, h, p), h_final


class Mamba2(nn.Module):
    """Parameters as the reference's ``mamba2_init``: ``w_in`` (D, d_inner +
    conv_dim + H) (the fused [z | xBC | dt] projection), ``conv_w`` (W,
    conv_dim) at W^-0.5 and ``conv_b``, in the parameter dtype; ``a_log``,
    ``dt_bias``, ``d_skip`` (H,) and ``norm.scale`` (d_inner) in float32;
    ``w_out`` (d_inner, D) at d_inner^-0.5.  conv_dim = d_inner + 2N."""

    def __init__(self, cfg, *, dtype=torch.float32, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        D = cfg.d_model
        d_inner, h, _, n = _dims(cfg)
        conv_dim = d_inner + 2 * n
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.w_in = normal((D, d_inner + conv_dim + h), **kw)
        self.conv_w = normal((cfg.conv_width, conv_dim), scale=cfg.conv_width**-0.5, **kw)
        self.conv_b = nn.Parameter(torch.zeros(conv_dim, dtype=dtype, device=device))
        # The reference's float32 tables, computed as it does (linspace in
        # float32, then log / log(expm1)).
        lin = np.linspace(1.0, 16.0, h, dtype=np.float32)
        self.a_log = nn.Parameter(torch.from_numpy(np.log(lin)).to(device))
        lin = np.linspace(1e-3, 1e-1, h, dtype=np.float32)
        self.dt_bias = nn.Parameter(torch.from_numpy(np.log(np.expm1(lin))).to(device))
        self.d_skip = nn.Parameter(torch.ones(h, device=device))
        self.norm = RMSNorm(d_inner, eps=cfg.norm_eps, device=device)
        self.w_out = normal((d_inner, D), scale=d_inner**-0.5, **kw)

    def _in_proj(self, x: torch.Tensor):
        d_inner, _, _, n = _dims(self.cfg)
        (zxbcdt,) = ws_in(x, self.w_in)  # a weight-stationary decode: summed over data
        conv_dim = d_inner + 2 * n
        return zxbcdt[..., :d_inner], zxbcdt[..., d_inner:d_inner + conv_dim], zxbcdt[..., d_inner + conv_dim:]

    def _conv_apply(self, xbc: torch.Tensor, carry: Optional[torch.Tensor] = None):
        """Causal depthwise conv over (B, S, conv_dim) as W shifted
        multiply-adds, then SiLU; returns (out, the last W − 1 inputs)."""
        w = self.conv_w.to(xbc.dtype)
        width, s = w.shape[0], xbc.shape[1]
        if carry is None:
            pad = xbc.new_zeros((xbc.shape[0], width - 1, xbc.shape[-1]))
        else:
            pad = carry.to(xbc.dtype)
        xp = torch.cat([pad, xbc], dim=1)
        out = 0
        for i in range(width):
            out = out + xp[:, i:i + s] * w[i]
        out = out + self.conv_b.to(xbc.dtype)
        new_carry = xp[:, xp.shape[1] - (width - 1):] if width > 1 else pad
        return tF.silu(out), new_carry

    def _gates(self, dt_raw: torch.Tensor):
        """(log decay, dt), each (B, S, H) float32."""
        dt = tF.softplus(dt_raw.float() + self.dt_bias)
        return -torch.exp(self.a_log) * dt, dt

    def _split(self, xbc: torch.Tensor):
        d_inner, _, _, n = _dims(self.cfg)
        return xbc[..., :d_inner], xbc[..., d_inner:d_inner + n], xbc[..., d_inner + n:]

    def _out(self, y: torch.Tensor, z: torch.Tensor, cd: torch.dtype, batch: Optional[int] = None) -> torch.Tensor:
        """y (B, S, d_inner) float32 after the skip → the block's output; a
        weight-stationary decode's data shard of the rows gathered to the
        step's ``batch`` before ``w_out``."""
        y = self.norm(y.to(cd) * tF.silu(z))
        if batch is not None and y.shape[0] != batch:
            y = data_gather(y)
        return y @ self.w_out.to(cd)

    def forward(self, x: torch.Tensor, return_cache: bool = False):
        """x (B, S, D) → y (B, S, D) [, :class:`SSMCache`]."""
        bsz, s, _ = x.shape
        d_inner, h, p, n = _dims(self.cfg)
        z, xbc, dt_raw = self._in_proj(x)
        xbc, conv_carry = self._conv_apply(xbc)
        xs, b_in, c_in = self._split(xbc)
        xh = xs.reshape(bsz, s, h, p).float()
        log_a, dt = self._gates(dt_raw)
        h0 = x.new_zeros((bsz, h, p, n), dtype=torch.float32)
        y, h_final = ssd_chunked(xh, b_in.float(), c_in.float(), log_a, dt, h0, self.cfg.chunk_size)
        y = y + self.d_skip[:, None] * xh
        out = self._out(y.reshape(bsz, s, d_inner), z, x.dtype)
        return (out, SSMCache(state=h_final, conv=conv_carry)) if return_cache else out

    def init_cache(self, batch: int, dtype: torch.dtype = torch.float32) -> SSMCache:
        """The empty decode state: a zero SSM state (float32) and conv
        history (``dtype``)."""
        d_inner, h, p, n = _dims(self.cfg)
        dev = self.w_in.device
        return SSMCache(state=torch.zeros(batch, h, p, n, device=dev),
                        conv=torch.zeros(batch, self.cfg.conv_width - 1, d_inner + 2 * n, dtype=dtype, device=dev))

    def decode(self, x: torch.Tensor, cache: SSMCache) -> Tuple[torch.Tensor, SSMCache]:
        """One token: x (B, 1, D) → (y (B, 1, D), new cache), O(H·P·N).
        A weight-stationary step over a state of its data shard's rows
        updates those rows."""
        batch, bsz = x.shape[0], cache.state.shape[0]
        d_inner, h, p, _ = _dims(self.cfg)
        z, xbc, dt_raw = (own_rows(t, bsz) for t in self._in_proj(x))
        xbc, conv_carry = self._conv_apply(xbc, carry=cache.conv)
        xs, b_in, c_in = self._split(xbc[:, 0])
        xh = xs.reshape(bsz, h, p).float()
        log_a, dt = self._gates(dt_raw)
        decay = torch.exp(log_a[:, 0])  # (B, H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], b_in.float(), xh)
        state = cache.state * decay[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", c_in.float(), state)
        y = y + self.d_skip[:, None] * xh
        return self._out(y.reshape(bsz, 1, d_inner), z, x.dtype, batch), SSMCache(state=state, conv=conv_carry)
