"""The decoder LM: embed → stack (pattern-driven blocks) → final norm → head.

Port of ``repro/models/model.py`` as an ``nn.Module`` whose parameter names
are the reference's tree, the stack unrolled to one entry per layer
(``embed.table``, ``stack.<layer>.<block param>``, the shared block's
``stack.shared.<block param>``, ``final_norm.scale``, ``head.w``; see
:func:`repro_torch.utils.params.load_reference_model`).  Every block kind
of the reference is ported: ``attn``, ``attn_local``, ``moe``,
``spectral``, ``mamba2``, ``mlstm``, ``slstm`` and ``shared_attn``.
Parameters are in ``cfg.param_dtype``; activations in
``cfg.compute_dtype``, each weight cast to it at its use as the reference
writes ``params[...].astype(cd)``; logits in float32.

The spectral layers' convolutions run through the planned FFTs, so on the
card through the hand-written kernels; everything else is plain PyTorch.
``device=None`` builds the model on the card (raising without one),
``device="cpu"`` on the plain route.  The forward returns the hidden
states and the summed aux loss of the MoE layers (0 without one), as the
reference's ``forward``.  :func:`loss_fn` is the training loss: the chunked
cross-entropy (the (B, S, vocab) logits never materialise at once), z-loss,
``loss_mask`` and the aux term, as the reference's.

The modality frontends are the reference's stubs.  An audio config
(``frontend="audio"``, musicgen-large) takes precomputed frame embeddings
(B, S, D) in place of tokens; a vision config (``"vision"``, qwen2-vl-72b)
takes token ids whose first positions precomputed patch embeddings
overwrite, and (B, 3, S) M-RoPE ids.  The inputs are keywords named as the
reference's batch keys: ``tokens``, ``positions``, ``frame_embeds``,
``vision_embeds``, ``mrope_positions`` (and :func:`loss_fn` reads a batch
dict of those keys); ``decode_step`` takes the reference's ``embeds=`` and
``mrope_positions=``.

A sharded model (:func:`repro_torch.sharding.shard.shard_model`) serves as
it trains: ``prefill`` and ``decode_step`` take this rank's rows of the
batch (:func:`repro_torch.sharding.shard.data_rows`), compute on the local
shards through the same ``model_copy`` / ``model_sum`` points as the
forward (each block's unit gathered per call) and return the full-vocab
logits of those rows (the vocab slices gathered over ``model``); the
caches are this rank's: its rows, its kv heads (the kv heads its query
heads read where the kv heads do not divide ``model``), its spectral
channels.  A batch that does not split over ``data`` is replicated; then
a cache whose kv heads do not divide ``model`` is split by slots
(:class:`~repro_torch.models.layers.attention.SeqKVCache`), as the
reference's ``cache_shardings``.  A model sharded with
``decode_weight_stationary`` decodes as the reference's FSDP decode: the
weights stay the training shards (nothing gathered over ``data``), the
step's batch is replicated over ``data`` (``data_rows(..., decode=True)``)
and the residual stream is this rank's ``embed`` slice; every data rank
returns the same logits.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as tF
from torch import nn

from repro_torch.core import fft as fft_lib
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers.embedding import Embedding, Head
from repro_torch.models.layers.norms import RMSNorm
from repro_torch.models.stack import Stack
from repro_torch.runtime import tracing
from repro_torch.sharding import shard

__all__ = ["DecoderLM", "loss_fn"]


class DecoderLM(nn.Module):
    """The LM of one ``ModelConfig``, its parameters drawn from ``generator``
    (on the generator's own device) at the reference's shapes and scales.
    The frontends add no parameter."""

    def __init__(self, cfg, *, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = fft_lib._resolve_device(device)
        kw = dict(dtype=getattr(torch, cfg.param_dtype), device=dev, generator=generator)
        self.cfg = cfg
        self.embed = Embedding(cfg, **kw)
        self.stack = Stack(cfg, **kw)
        self.final_norm = RMSNorm(cfg.d_model, eps=cfg.norm_eps, device=dev)
        self.head = Head(cfg, **kw)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    def _embed_inputs(self, tokens, frame_embeds=None, vision_embeds=None) -> torch.Tensor:
        """The stack's input (B, S, D) in the compute dtype: an audio
        config's ``frame_embeds``; else the token embedding, its first
        positions overwritten by a vision config's ``vision_embeds`` (B, F,
        D), as many as the sequence holds (F, or S where S < F)."""
        cd = self.compute_dtype
        if self.cfg.frontend == "audio":
            if frame_embeds is None:
                raise ValueError(f"{self.cfg.name}: an audio model takes frame_embeds (B, S, d_model), not tokens")
            return torch.as_tensor(frame_embeds, device=self.device).to(cd)
        x = self.embed(self._tokens(tokens), cd)
        if self.cfg.frontend == "vision" and vision_embeds is not None:
            ve = torch.as_tensor(vision_embeds, device=self.device)
            n = min(ve.shape[1], x.shape[1])
            x = torch.cat([ve[:, :n].to(cd), x[:, n:]], dim=1)
        return x

    def _ids(self, ids) -> Optional[torch.Tensor]:
        return None if ids is None else torch.as_tensor(ids, dtype=torch.long, device=self.device)

    def forward(self, tokens=None, positions=None, *, frame_embeds=None, vision_embeds=None,
                mrope_positions=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) (an audio config: ``frame_embeds`` (B, S, D)
        instead) → (the final-normed hidden states (B, S, D), the layers'
        summed aux loss, float32 0-d).  ``positions`` (B, S) default to
        0 … S − 1; ``vision_embeds`` (B, F, D) and ``mrope_positions``
        (B, 3, S) feed a vision config."""
        x = self._embed_inputs(tokens, frame_embeds, vision_embeds)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=self.device).expand(b, s) if positions is None else self._ids(positions)
        x, _, aux = self.stack(x, positions, mrope_positions=self._ids(mrope_positions))
        return self.final_norm(x), aux

    def logits_fn(self, tokens=None, positions=None, **inputs) -> torch.Tensor:
        """(B, S, vocab) float32 logits: the small-model and check path
        (``inputs``: :meth:`forward`'s keywords; a sharded model's are this
        rank's vocab slice)."""
        with shard.gathered(self):
            return self.head(self(tokens, positions, **inputs)[0], self.embed.table)

    @torch.no_grad()
    @tracing.span("model.prefill")
    def prefill(self, tokens=None, *, frame_embeds=None, vision_embeds=None,
                mrope_positions=None) -> Tuple[torch.Tensor, List]:
        """The prompt's last-position logits (B, vocab) and the per-layer
        caches it leaves (KV in natural order, length S; spectral states
        already in decode layout).  The inputs are :meth:`forward`'s."""
        with shard.gathered(self):
            x = self._embed_inputs(tokens, frame_embeds, vision_embeds)
            b, s = x.shape[:2]
            positions = torch.arange(s, device=self.device).expand(b, s)
            x, caches, _ = self.stack(x, positions, return_cache=True, mrope_positions=self._ids(mrope_positions))
            x = self.final_norm(x[:, -1:])
            return shard.model_gather(self.head(x, self.embed.table)[:, 0]), caches

    @torch.no_grad()
    def decode_step(self, tokens, caches: List, t, *, embeds=None, mrope_positions=None) -> Tuple[torch.Tensor, List]:
        """One decode step.  tokens (B,), or for an audio config ``embeds``
        (B, 1, D) where given (the tokens through the embedding table
        otherwise, as the reference); ``t`` the position being written (its
        KV slot), an int (one timeline) or a (B,) tensor of per-slot
        positions; ``mrope_positions`` (B, 3, 1) the step's M-RoPE ids for a
        vision config (standard RoPE at ``t`` without them).  Returns
        (logits (B, vocab), new caches); KV caches are written in place."""
        with shard.decoding(self), shard.gathered(self):
            if self.cfg.frontend == "audio" and embeds is not None:
                x = shard.stream_slice(torch.as_tensor(embeds, device=self.device).to(self.compute_dtype))
            else:
                x = self.embed(self._tokens(tokens)[:, None], self.compute_dtype)
            x, caches = self.stack.decode(x, caches, t, self._ids(mrope_positions))
            return shard.model_gather(self.head(self.final_norm(x), self.embed.table)[:, 0]), caches

    def cache_init(self, batch: int, max_len: int, dtype: Optional[torch.dtype] = None) -> List:
        """Empty per-layer decode caches for ``batch`` rows and ``max_len``
        positions (KV in ``dtype``, default the compute dtype); a sharded
        model's are this rank's shards of the global batch's caches
        (:func:`repro_torch.launch.shardings.local_caches`: its rows, kv
        heads, channels and, where the spec splits them, slots)."""
        dtype = dtype or self.compute_dtype
        if not shard.is_sharded(self):
            return self.stack.cache_init(batch, max_len, dtype)
        from repro_torch.launch import shardings

        mine = shardings.local_caches(self, shardings.meta_caches(self.cfg, batch, max_len, dtype))
        out = []
        with shard.context(self):
            for block, cache in zip(self.stack, mine):
                if isinstance(cache, (attn_lib.KVCache, attn_lib.SeqKVCache)):  # zeros
                    out.append(type(cache)(*[torch.zeros(t.shape, dtype=t.dtype, device=self.device)
                                             if torch.is_tensor(t) else t for t in cache]))
                else:
                    out.append(block.cache_init(cache[0].shape[0], max_len, dtype))
        return out

    @torch.no_grad()
    def prepare_decode_caches(self, caches: List, max_len: int) -> List:
        """Prefill caches (natural order, length S) into decode layout.

        Global-attention layers: the KV axis padded out to ``max_len``
        slots.  Sliding-window layers: the last ``window`` positions
        re-scattered into ring order (slot = position % slots), with
        ``min(window, max_len)`` slots as :func:`init_kv_cache` makes them.
        Quantised to int8 where ``cfg.kv_cache_dtype`` says so.  The
        recurrent states (:class:`SSMCache`, :class:`MLSTMCache`,
        :class:`SLSTMCache`) and the spectral states pass through: the
        prefill built them in decode layout.
        """
        out = []
        for block, cache in zip(self.stack, caches, strict=True):
            if not isinstance(cache, attn_lib.KVCache):
                out.append(cache)
                continue
            k, v = cache.k, cache.v  # (B, S, KV, hd)
            s = k.shape[1]
            window = block.mixer.window
            if window:
                slots = min(window, max_len)
                keep = min(window, s)
                at = torch.arange(s - keep, s, device=k.device) % slots
                kw = k.new_zeros((k.shape[0], slots) + k.shape[2:])
                vw = torch.zeros_like(kw)
                kw[:, at], vw[:, at] = k[:, s - keep:], v[:, s - keep:]
                k, v = kw, vw
            elif max_len > s:
                k, v = (tF.pad(t, (0, 0, 0, 0, 0, max_len - s)) for t in (k, v))
            if self.cfg.kv_cache_dtype == "int8":
                (kq, ks), (vq, vs) = attn_lib.quant_tok(k), attn_lib.quant_tok(v)
                out.append(attn_lib.KVCache(k=kq, v=vq, k_scale=ks, v_scale=vs))
            else:
                out.append(attn_lib.KVCache(k=k, v=v))
        return out


def _chunk_ce(model: DecoderLM, hidden: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor):
    """Chunked cross-entropy over ``cfg.loss_chunk`` positions at a time.

    hidden (B, S, D); targets and mask (B, S).  Returns (Σ nll, Σ lse², Σ
    mask), each float32, summed chunk after chunk as the reference's scan
    and its remainder.  With the vocab over ``model`` each rank's logits
    are its slice: the max, the sum of exponentials and the target's logit
    meet over ``model``."""
    s = hidden.shape[1]
    c = min(model.cfg.loss_chunk, s)
    nll = z2 = cnt = hidden.new_zeros((), dtype=torch.float32)
    for start in range(0, s, c):
        ms = mask[:, start:start + c]
        logits = model.head(hidden[:, start:start + c], model.embed.table)
        tc = targets[:, start:start + c]
        vocab = logits.shape[-1]
        if vocab == model.cfg.vocab_size:
            lse = torch.logsumexp(logits, dim=-1)
            tgt = logits.gather(-1, tc[..., None])[..., 0]
        else:
            top = shard.model_max(logits.detach().amax(-1))
            lse = shard.model_sum((logits - top[..., None]).exp().sum(-1)).log() + top
            at = tc - shard.tp().rank * vocab
            mine = (at >= 0) & (at < vocab)
            tgt = shard.model_sum(logits.gather(-1, at.clamp(0, vocab - 1)[..., None])[..., 0] * mine)
        nll = nll + ((lse - tgt) * ms).sum()
        z2 = z2 + (lse.square() * ms).sum()
        cnt = cnt + ms.sum()
    return nll, z2, cnt


def loss_fn(model: DecoderLM, batch: dict, train_cfg=None):
    """Scalar LM loss and its metrics.  ``batch``: ``tokens`` (an audio
    config: ``frame_embeds``) and ``targets`` (B, S) integers, optional
    ``loss_mask`` (B, S), ``positions``, and a vision config's
    ``vision_embeds`` and ``mrope_positions``.

    loss = Σ nll / n + z_loss · Σ lse² / n + aux, n = max(Σ mask, 1), aux
    the MoE layers' load-balance term (0 without one); metrics ``loss``,
    ``ce``, ``aux``, ``tokens`` as 0-d float32 tensors.

    A sharded model's (:func:`repro_torch.sharding.shard.shard_model`)
    ``batch`` holds this rank's rows; the sums over them (nll, lse², mask)
    are summed over ``data`` before the quotients, so the loss and the
    metrics are the global batch's, on every rank."""
    with shard.gathered(model):
        return _loss(model, batch, train_cfg)


def _loss(model: DecoderLM, batch: dict, train_cfg):
    hidden, aux = model(batch.get("tokens"), batch.get("positions"), frame_embeds=batch.get("frame_embeds"),
                        vision_embeds=batch.get("vision_embeds"), mrope_positions=batch.get("mrope_positions"))
    targets = torch.as_tensor(batch["targets"], dtype=torch.long, device=model.device)
    mask = batch.get("loss_mask")
    mask = (torch.ones(targets.shape, device=model.device) if mask is None
            else torch.as_tensor(mask, device=model.device).to(torch.float32))
    nll, z2, cnt = shard.data_sum(torch.stack(_chunk_ce(model, hidden, targets, mask)))
    cnt = cnt.clamp(min=1.0)
    ce = nll / cnt
    z_coef = getattr(train_cfg, "z_loss", 1e-4) if train_cfg else 1e-4
    loss = ce + z_coef * (z2 / cnt) + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux, "tokens": cnt}
