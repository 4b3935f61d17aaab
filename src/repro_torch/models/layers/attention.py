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

A sharded decode step reads the cache in the layout the reference's
``cache_shardings`` gives it (``launch/shardings.py``): this rank's rows
where the batch splits over ``data``, its kv heads, and, where the kv
heads do not divide ``model`` and the batch is replicated, its range of
slots (a :class:`SeqKVCache`).  Then the query of every head is gathered
over ``model`` (the cache holds every kv head of its slots), the new key
and value land only on the rank that owns the slot, the mask reads the
global slot index, and the softmax's max, its sum and the value products
are reduced over the slots' mesh axes.  Under a weight-stationary decode
(:func:`repro_torch.sharding.shard.ws`) q, k and v are the partial
products of this rank's ``embed`` slice summed over ``data``, and a cache
whose rows split over ``data`` is attended by its rows, the outputs
gathered over ``data`` before ``wo``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from repro_torch.models.layers import rope as rope_lib
from repro_torch.sharding import shard
from repro_torch.sharding.shard import local, model_copy, model_sum, tp
from repro_torch.utils.params import cast, normal

__all__ = ["Attention", "KVCache", "SeqKVCache", "init_kv_cache", "slot_index", "quant_tok"]

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


class SeqKVCache(NamedTuple):
    """A rank's shard of a decode KV cache whose slots are split over the
    mesh axes ``axes`` (in that order, as the reference's spec names them):
    k/v (B, n, KV, hd) hold global slots ``start`` … ``start + n − 1`` of
    every kv head, and the int8 scales (B, n, KV) the same slots."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    start: int = 0
    axes: tuple = ()


def quant_tok(x: torch.Tensor):
    """x: (B, S, KV, hd) → int8 and its per-(B, S, KV) absmax scale."""
    x32 = x.float()
    scale = (x32.abs().amax(-1) + 1e-9) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def init_kv_cache(cfg, batch: int, max_len: int, *, window: Optional[int] = None,
                  dtype=torch.bfloat16, device=None, kv_heads: Optional[int] = None) -> KVCache:
    """Zeros for ``batch`` rows of ``max_len`` positions (a window layer's
    ring of ``min(window, max_len)`` slots) and ``kv_heads`` kv heads
    (default all of them; a sharded layer's own)."""
    slots = min(window, max_len) if window else max_len
    shape = (batch, slots, kv_heads or cfg.num_kv_heads, cfg.resolved_head_dim)
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
        if shard.ws():
            q, k, v = shard.ws_in(x, self.wq, self.wk, self.wv)
        else:
            xq = model_copy(x) if self._sharded() else x
            xkv = xq if self.wk.shape[1] != self.cfg.num_kv_heads else x
            q = xq @ cast(self.wq, cd).flatten(1)
            k, v = (xkv @ cast(w, cd).flatten(1) for w in (self.wk, self.wv))
        q, k, v = (t.unflatten(-1, w.shape[1:]) for t, w in ((q, self.wq), (k, self.wk), (v, self.wv)))
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
        return local(self.wq).shape[1] != self.cfg.num_heads

    def kv_local(self) -> tuple:
        """(the first kv head, how many) of the kv heads this rank's query
        heads read: all of them unsharded; the rank's shard where the kv
        heads are sharded with the heads; else (kv heads replicated over
        ``model``) the whole kv heads its heads map to, which its cache
        holds."""
        kv, g = self.cfg.num_kv_heads, self.cfg.num_heads // self.cfg.num_kv_heads
        if not self._sharded():
            return 0, kv
        mine = local(self.wk).shape[1]
        if mine != kv:
            return tp().rank * mine, mine
        heads = local(self.wq).shape[1]
        h0 = tp().rank * heads
        return h0 // g, (h0 + heads - 1) // g + 1 - h0 // g

    def _cache_kv(self, t: torch.Tensor) -> torch.Tensor:
        """k or v (B, S, KV, hd) cut to the kv heads this rank caches."""
        k0, n = self.kv_local()
        return t if t.shape[2] == n else t.narrow(2, k0, n)

    def cache_init(self, batch: int, max_len: int, dtype: torch.dtype, device) -> KVCache:
        """This layer's empty decode cache (this rank's kv heads)."""
        return init_kv_cache(self.cfg, batch, max_len, window=self.window, dtype=dtype, device=device,
                             kv_heads=self.kv_local()[1])

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
        y = out.flatten(2) @ cast(self.wo, cd).flatten(0, 1)
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
        return (y, KVCache(k=self._cache_kv(k), v=self._cache_kv(v))) if return_cache else y

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
        ``cache`` (a :class:`KVCache`, or this rank's slots of a
        :class:`SeqKVCache`) in place and returns (y, cache)."""
        b = x.shape[0]
        cfg = self.cfg
        if torch.is_tensor(t):
            t_vec = t.to(device=x.device, dtype=torch.long)
        else:
            t_vec = torch.full((b,), int(t), dtype=torch.long, device=x.device)
        q, k_new, v_new = self._qkv(x, t_vec[:, None], mrope_positions)
        rows = cache.k.shape[0]
        if rows != b:
            # A weight-stationary step over a cache whose rows are split
            # over data: this rank attends its own rows.
            r0 = shard.data_rank() * rows
            q, k_new, v_new, t_vec = (z.narrow(0, r0, rows) for z in (q, k_new, v_new, t_vec))
        seq = isinstance(cache, SeqKVCache)
        hd = cfg.resolved_head_dim
        h_own = self.wq.shape[1]
        h0 = tp().rank * h_own if self._sharded() else 0
        if seq:
            # Every kv head of this rank's slots: the query of every head.
            axes, start = cache.axes, cache.start
            if self._sharded():
                q = shard.model_gather(q, dim=2)
            h, k0, kv, h_first = cfg.num_heads, 0, cfg.num_kv_heads, 0
        else:
            axes, start = (), 0
            k_new, v_new = self._cache_kv(k_new), self._cache_kv(v_new)
            (k0, kv), h, h_first = self.kv_local(), h_own, h0
        kv_of = [(h_first + j) // (cfg.num_heads // cfg.num_kv_heads) - k0 for j in range(h)]  # cached kv head
        g = h // kv
        grouped = h % kv == 0 and kv_of == [j // g for j in range(h)]

        n_slots = cache.k.shape[1]
        total = n_slots * shard.axes_size(axes)
        quantized = cache.k.dtype == torch.int8
        at = slot_index(t_vec, total, self.window)
        loc = (at - start).clamp(0, n_slots - 1)
        own = (at >= start) & (at < start + n_slots) if seq else None
        ridx = torch.arange(rows, device=x.device)
        if quantized:
            (kq, ks), (vq, vs) = quant_tok(k_new), quant_tok(v_new)
            news = ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks), (cache.v_scale, vs))
        else:
            news = ((cache.k, k_new), (cache.v, v_new))
        for buf, new in news:
            new = new[:, 0].to(buf.dtype)
            if own is not None:  # only the rank that owns the slot writes it
                new = torch.where(own.view((rows,) + (1,) * (new.dim() - 1)), new, buf[ridx, loc])
            buf[ridx, loc] = new

        ck, cv, cks, cvs = cache[:4]
        if not grouped:
            # This rank's heads straddle kv-head groups: they read an
            # expanded copy, each head its own kv head.
            at_kv = torch.tensor(kv_of, device=x.device)
            ck, cv = ck.index_select(2, at_kv), cv.index_select(2, at_kv)
            if quantized:
                cks, cvs = cks.index_select(2, at_kv), cvs.index_select(2, at_kv)
            kv, g = h, 1
        qg = q.reshape(rows, kv, g, hd)
        if quantized:
            # int8 × int8 with the products summed exactly (float64 holds the
            # reference's int32 sums: |Σ| < 2^53); scales folded back per
            # (b, kv[, slot]).
            q_s = (qg.float().abs().amax(-1) + 1e-9) / 127.0  # (B,KV,G)
            q_q = torch.clamp(torch.round(qg.float() / q_s[..., None]), -127, 127)
            scores = torch.einsum("bngh,bknh->bngk", q_q.double(), ck.double()).float()
            scores = scores * q_s[..., None] * cks.transpose(1, 2)[:, :, None, :]
        else:
            scores = torch.einsum("bngh,bknh->bngk", qg, ck).float()
        scores = self._softcap(scores * hd**-0.5)
        # A ring holds a live key in every slot once t ≥ slots.
        lim = t_vec.clamp(max=total - 1) if self.window else t_vec
        valid = (start + torch.arange(n_slots, device=x.device))[None, :] <= lim[:, None]  # (B, slots)
        scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
        if quantized:
            # The per-slot v scale rides the contracted axis: fold it into
            # the exponentials and quantise them against their max over
            # every slot (the quotients of the normalised probs, so every
            # shard of the slots rounds alike), then int8 × int8 again.
            (top,) = shard.seq_reduce(axes, scores.amax(-1, keepdim=True), op="max")
            e = torch.exp(scores - top)
            pv = e * cvs.transpose(1, 2)[:, :, None, :]
            (pv_top,) = shard.seq_reduce(axes, pv.abs().amax(-1, keepdim=True), op="max")
            pv_s = (pv_top + 1e-12) / 127.0
            pv_q = torch.clamp(torch.round(pv / pv_s), -127, 127)
            out = torch.einsum("bngk,bknh->bngh", pv_q.double(), cv.double())
            out, den = shard.seq_reduce(axes, out, e.sum(-1, keepdim=True).double())
            out = (out * (pv_s.double() / den)).to(x.dtype)
        elif axes:
            # Each shard's share of the softmax and of the value products,
            # in float32, summed over the slots' axes.
            (top,) = shard.seq_reduce(axes, scores.amax(-1, keepdim=True), op="max")
            e = torch.exp(scores - top)
            (den,) = shard.seq_reduce(axes, e.sum(-1, keepdim=True))
            part = torch.einsum("bngk,bknh->bngh", (e / den).to(cv.dtype).float(), cv.float())
            (out,) = shard.seq_reduce(axes, part)
            out = out.to(x.dtype)
        else:
            probs = torch.softmax(scores, dim=-1)
            out = torch.einsum("bngk,bknh->bngh", probs.to(cv.dtype), cv)
        out = out.reshape(rows, 1, h, hd)
        if seq and h != h_own:
            out = out.narrow(2, h0, h_own)  # this rank's heads for wo
        if rows != b:
            out = shard.data_gather(out, 0)
        return self._out(out, x.dtype), cache
