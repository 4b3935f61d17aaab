"""GQA attention: full, chunked (long-context), sliding-window, decode.

Port of ``repro/models/layers/attention.py`` as an ``nn.Module``.  The
reference computes attention in XLA outside any Pallas kernel, so this is
plain PyTorch: projections as ``x @ w`` with ``w`` cast to the activation's
dtype at each use, scores and softmax in float32, the score and value
contractions as ``einsum``.

* :meth:`Attention.forward` — train/prefill.  Exact causal attention;
  above ``cfg.attn_chunk_threshold`` query positions it loops over q blocks
  of ``cfg.attn_chunk`` (bounded score memory, exact softmax per block).
  Sliding-window layers give each q block only its KV band.
* :meth:`Attention.decode` — one token against a :class:`KVCache`.  Global
  layers keep ``max_len`` slots; sliding-window layers a ring of ``window``
  slots (slot ``t % window``, keys stored already rotated).  The cache is
  written in place; the position ``t`` is an int (one timeline) or a (B,)
  tensor (each serving slot its own).

GQA K/V are expanded to the full head count before the score einsums in the
forward; the cache stays in kv-head form.  Logit softcap where configured.
In a sharded model (heads over ``model``) the forward computes this rank's
heads: the input enters the head shards through ``model_copy``, kv heads
that do not divide the axis (replicated, as the rules' fallback gives) are
expanded and cut to the local heads, and the output projection's partial
sums meet in ``model_sum``, where the reference annotates q/k/v and y.
q and k rotate by M-RoPE where ``cfg.rope_kind == "mrope"`` and (B, 3, S)
``mrope_positions`` are given, else by standard RoPE on ``positions`` (the
reference's rule: a vision config served as text rotates as any other).
The causal mask and the decode cache slot never read the M-RoPE ids.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from repro_torch.models.layers import rope as rope_lib
from repro_torch.sharding.shard import model_copy, model_sum, tp
from repro_torch.utils.params import normal

__all__ = ["Attention", "KVCache", "init_kv_cache", "slot_index", "quant_tok"]

NEG_INF = -1e30


class KVCache(NamedTuple):
    """Decode KV cache; optionally int8 (per-slot, per-kv-head scales).

    k/v: (B, S_slots, KV, hd) in the compute dtype, or int8 with
    k_scale/v_scale (B, S_slots, KV) float32 absmax scales.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def quant_tok(x: torch.Tensor):
    """x: (B, S, KV, hd) → int8 and its per-(B, S, KV) absmax scale."""
    x32 = x.float()
    scale = (x32.abs().amax(-1) + 1e-9) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def init_kv_cache(cfg, batch: int, max_len: int, *, window: Optional[int] = None,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    slots = min(window, max_len) if window else max_len
    shape = (batch, slots, cfg.num_kv_heads, cfg.resolved_head_dim)
    if cfg.kv_cache_dtype == "int8":
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:3], device=device),
            v_scale=torch.zeros(shape[:3], device=device),
        )
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def slot_index(t: torch.Tensor, slots: int, window: Optional[int]) -> torch.Tensor:
    """The cache slot each row's position ``t`` (B,) is written to: the ring
    slot ``t % slots`` of a window layer, else ``t``, clamped to the last
    slot as the reference's ``dynamic_update_slice`` clamps its start."""
    return t % slots if window else t.clamp(max=slots - 1)


def _expand_kv(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, S, KV, hd) → (B, S, KV·g, hd): head h reads kv head h // g."""
    return x if g == 1 else x.repeat_interleave(g, dim=2)


class Attention(nn.Module):
    """Parameters ``wq`` (D, H, hd), ``wk``/``wv`` (D, KV, hd) at fan-in
    scale and ``wo`` (H, hd, D) at (H·hd)^-0.5.  ``window`` makes it a
    sliding-window layer."""

    def __init__(self, cfg, *, window: Optional[int] = None, dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.window = cfg, window
        D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.wq = normal((D, H, hd), **kw)
        self.wk = normal((D, KV, hd), **kw)
        self.wv = normal((D, KV, hd), **kw)
        self.wo = normal((H, hd, D), scale=(H * hd) ** -0.5, **kw)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor, mrope_positions: Optional[torch.Tensor] = None):
        """Project and rotate.  x: (B, S, D) → q (B,S,H,hd), k/v (B,S,KV,hd);
        positions (B, S), mrope_positions (B, 3, S) or None."""
        cd = x.dtype
        xq = model_copy(x) if self._sharded() else x
        xkv = xq if self.wk.shape[1] != self.cfg.num_kv_heads else x
        q = (xq @ self.wq.to(cd).flatten(1)).unflatten(-1, self.wq.shape[1:])
        k = (xkv @ self.wk.to(cd).flatten(1)).unflatten(-1, self.wk.shape[1:])
        v = (xkv @ self.wv.to(cd).flatten(1)).unflatten(-1, self.wv.shape[1:])
        cfg = self.cfg
        if cfg.rope_kind == "mrope" and mrope_positions is not None:
            q = rope_lib.apply_mrope(q, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
            k = rope_lib.apply_mrope(k, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = rope_lib.apply_rope(q, positions, cfg.rope_theta)
            k = rope_lib.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _sharded(self) -> bool:
        """Whether this rank holds a shard of the heads (a sharded model)."""
        return self.wq.shape[1] != self.cfg.num_heads

    def _expand(self, t: torch.Tensor, g: int) -> torch.Tensor:
        """k or v (B, S, KV, hd) → the keys or values of this rank's heads:
        all of them unsharded; kv heads replicated over ``model`` while the
        heads are sharded are expanded and cut to the local heads."""
        heads = self.wq.shape[1]
        if t.shape[2] * g == heads:
            return _expand_kv(t, g)
        return _expand_kv(model_copy(t), g).narrow(2, tp().rank * heads, heads)

    def _softcap(self, scores: torch.Tensor) -> torch.Tensor:
        cap = self.cfg.attn_logit_softcap
        return torch.tanh(scores / cap) * cap if cap else scores

    def _attend(self, q, k_full, v_full, mask):
        """q (B,Sq,H,hd); k/v head-expanded (B,Sk,H,hd); mask (Sq, Sk) bool."""
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k_full).float() * q.shape[-1] ** -0.5
        scores = self._softcap(scores).masked_fill(~mask, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(v_full.dtype), v_full)

    def _out(self, out: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
        y = out.flatten(2) @ self.wo.to(cd).flatten(0, 1)
        return model_sum(y) if self._sharded() else y

    def forward(self, x: torch.Tensor, positions: torch.Tensor, return_cache: bool = False,
                mrope_positions: Optional[torch.Tensor] = None):
        """Causal (optionally banded) attention over a whole sequence.
        positions: (B, S); mrope_positions: (B, 3, S) M-RoPE ids or None; with
        ``return_cache`` also the rotated k and v."""
        s = x.shape[1]
        g = self.cfg.num_heads // self.cfg.num_kv_heads
        q, k, v = self._qkv(x, positions, mrope_positions)
        if s <= self.cfg.attn_chunk_threshold:
            pos = positions[0]
            mask = pos[None, :] <= pos[:, None]
            if self.window:
                mask &= pos[None, :] > (pos[:, None] - self.window)
            out = self._attend(q, self._expand(k, g), self._expand(v, g), mask)
        else:
            out = self._chunked(q, k, v, g)
        y = self._out(out, x.dtype)
        return (y, KVCache(k=k, v=v)) if return_cache else y

    def _chunked(self, q, k, v, g):
        """Exact attention by a loop over q blocks of C = ``attn_chunk``.

        The sequence is padded to whole blocks (padded keys sit at positions
        ≥ S, so the causal mask hides them; padded query rows are dropped).
        A window layer gives block ``blk`` only the chunk-aligned KV band of
        ``band`` keys from ``max(blk·C + C − band, 0)``, so score memory and
        work scale with the window.
        """
        b, s, h, hd = q.shape
        c, window = self.cfg.attn_chunk, self.window
        pad = (-s) % c
        if pad:
            q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        s_pad = s + pad
        banded = window is not None and window < s_pad
        band = ((window + c - 1) // c + 1) * c if banded else s_pad
        k_full, v_full = self._expand(k, g), self._expand(v, g)
        dev = q.device
        outs = []
        for start in range(0, s_pad, c):
            q_pos = start + torch.arange(c, device=dev)
            k_start = max(start + c - band, 0) if banded else 0
            kc, vc = k_full[:, k_start:k_start + band], v_full[:, k_start:k_start + band]
            k_pos = k_start + torch.arange(kc.shape[1], device=dev)
            mask = k_pos[None, :] <= q_pos[:, None]
            if window:
                mask &= k_pos[None, :] > (q_pos[:, None] - window)
            outs.append(self._attend(q[:, start:start + c], kc, vc, mask))
        return torch.cat(outs, dim=1)[:, :s]

    def decode(self, x: torch.Tensor, cache: KVCache, t: Union[int, torch.Tensor],
               mrope_positions: Optional[torch.Tensor] = None):
        """One decode step.  x: (B, 1, D); t: the position being written, an
        int (the whole batch at one timeline) or a (B,) tensor (each slot at
        its own).  The key goes to the slot of ``t``; it and the query rotate
        by ``mrope_positions`` (B, 3, 1) where the config takes M-RoPE and
        they are given (a vision prompt's text continues at M-RoPE ids apart
        from its slot), else by ``t``.  Writes the new key and value into
        ``cache`` in place and returns (y, cache)."""
        b = x.shape[0]
        cfg = self.cfg
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        g = h // kv
        if torch.is_tensor(t):
            t_vec = t.to(device=x.device, dtype=torch.long)
        else:
            t_vec = torch.full((b,), int(t), dtype=torch.long, device=x.device)
        q, k_new, v_new = self._qkv(x, t_vec[:, None], mrope_positions)

        slots = cache.k.shape[1]
        quantized = cache.k.dtype == torch.int8
        rows = torch.arange(b, device=x.device)
        at = slot_index(t_vec, slots, self.window)
        if quantized:
            (kq, ks), (vq, vs) = quant_tok(k_new), quant_tok(v_new)
            for buf, new in ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks), (cache.v_scale, vs)):
                buf[rows, at] = new[:, 0]
        else:
            cache.k[rows, at] = k_new[:, 0].to(cache.k.dtype)
            cache.v[rows, at] = v_new[:, 0].to(cache.v.dtype)

        qg = q.reshape(b, kv, g, hd)
        if quantized:
            # int8 × int8 with the products summed exactly (float64 holds the
            # reference's int32 sums: |Σ| < 2^53); scales folded back per
            # (b, kv[, slot]).
            q_s = (qg.float().abs().amax(-1) + 1e-9) / 127.0  # (B,KV,G)
            q_q = torch.clamp(torch.round(qg.float() / q_s[..., None]), -127, 127)
            scores = torch.einsum("bngh,bknh->bngk", q_q.double(), cache.k.double()).float()
            scores = scores * q_s[..., None] * cache.k_scale.transpose(1, 2)[:, :, None, :]
        else:
            scores = torch.einsum("bngh,bknh->bngk", qg, cache.k).float()
        scores = self._softcap(scores * hd**-0.5)
        # A ring holds a live key in every slot once t ≥ slots.
        lim = t_vec.clamp(max=slots - 1) if self.window else t_vec
        valid = torch.arange(slots, device=x.device)[None, :] <= lim[:, None]  # (B, slots)
        probs = torch.softmax(scores.masked_fill(~valid[:, None, None, :], NEG_INF), dim=-1)
        if quantized:
            # The per-slot v scale rides the contracted axis: fold it into
            # the probs before quantising them, then int8 × int8 again.
            pv = probs * cache.v_scale.transpose(1, 2)[:, :, None, :]
            pv_s = (pv.abs().amax(-1) + 1e-12) / 127.0
            pv_q = torch.clamp(torch.round(pv / pv_s[..., None]), -127, 127)
            out = torch.einsum("bngk,bknh->bngh", pv_q.double(), cache.v.double()).float()
            out = (out * pv_s[..., None]).to(x.dtype)
        else:
            out = torch.einsum("bngk,bknh->bngh", probs.to(cache.v.dtype), cache.v)
        return self._out(out.reshape(b, 1, h, hd), x.dtype), cache
