"""Batched decode engine: prefill / insert / decode phases over a model.

Port of ``repro/serving/engine.py``, the serving core under
:mod:`repro_torch.serving.spectral_serve`.  Three phases over an explicit
:class:`DecodeState` (continuous-batching-lite):

* **prefill** — run the prompt once, convert the caches to decode layout
  (:meth:`DecoderLM.prepare_decode_caches`) and sample the first token: a
  :class:`PrefillResult` for one request.
* **insert** — splice a prefilled request into slots of a *running* batch
  state: KV rows and the rows of a recurrent state (:class:`SSMCache`,
  :class:`MLSTMCache`, :class:`SLSTMCache`) are written at the slot's batch
  rows, spectral stream states are re-phased to the running window
  (:meth:`SpectralMixer.stream_rephase`), and the slot's token, length and
  done rows are reset.  Each slot keeps its own timeline (``decode_step``
  takes the (B,) length vector as per-slot positions).
* **decode** — ``steps`` decode steps: decode, sample, per-slot EOS
  masking.  Finished slots emit ``eos_id`` and their caches, lengths and
  last token stay frozen bit for bit (the step still computes them, batch
  lockstep, and the results are discarded) until something is inserted
  over them.  Done, EOS and lengths stay tensors: the loop reads nothing
  from the device, so the host syncs once per :meth:`Engine.decode`.

The engine prefills token prompts, as the reference's (``{"tokens":
prompts}``): a vision config is served as text, with standard RoPE (and its
int8 KV cache); an audio config, whose prompts are frame embeddings, is
refused with a ``ValueError`` (:func:`require_token_prompts`; the
reference's fails on the missing ``frame_embeds``).  An audio model is
served by its own ``prefill`` → ``prepare_decode_caches`` →
``decode_step(embeds=...)`` loop.

The reference freezes a finished row by the shape of each cache leaf; the
port's caches are per layer with the batch at axis 0, so it freezes by cache
type: a KV cache is written in place at one slot per row, and the step
writes a done row's old value back there; every field of a recurrent state
and a spectral state's batch tensors are chosen row by row (those a step
leaves alone are kept as they are).  Only the spectral states' last field
(the stream ``phase``, the ring's step) is global, a Python int that
advances for every slot.  ``Engine.generate`` keeps the whole-batch
convenience API.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional

import torch

from repro_torch.core import faults
from repro_torch.models.layers import attention as attn_lib
from repro_torch.models.layers.spectral import SpectralCache, SpectralStreamCache
from repro_torch.models.layers.ssm import SSMCache
from repro_torch.models.layers.xlstm import MLSTMCache, SLSTMCache
from repro_torch.runtime import tracing
from repro_torch.serving.sampling import sample

__all__ = ["ServeConfig", "Engine", "DecodeState", "PrefillResult", "require_token_prompts"]

#: Per-slot recurrent states: every field has the batch at axis 0.
RECURRENT_STATES = (SSMCache, MLSTMCache, SLSTMCache)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_new: int = 32
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    eos_id: int = 3
    seed: int = 0


class PrefillResult(NamedTuple):
    """One prefilled request, ready to insert: decode-layout caches (batch
    = the request's own, usually 1), first sampled token and prompt length
    per row."""

    caches: Any
    token: torch.Tensor   # (B,) int64
    length: torch.Tensor  # (B,) int64 — next position to write


class DecodeState(NamedTuple):
    """The running batch: one row per serving slot."""

    caches: Any
    tokens: torch.Tensor   # (B,) int64 — last token per slot (next step's input)
    lengths: torch.Tensor  # (B,) int64 — per-slot next write position
    done: torch.Tensor     # (B,) bool — finished (or never-filled) slots
    generator: torch.Generator  # the sampling stream


def require_token_prompts(cfg) -> None:
    """Raise ``ValueError`` for a config whose prompts are not token ids."""
    if cfg.frontend == "audio":
        raise ValueError(
            f"{cfg.name}: the serving engine prefills token prompts, and an audio model takes frame "
            "embeddings; drive DecoderLM.prefill(frame_embeds=...), prepare_decode_caches and "
            "decode_step(embeds=...) instead"
        )


def _rows_mask(done: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return done.view(-1, *([1] * (like.dim() - 1)))


def _keep_done_rows(done: torch.Tensor, old, new):
    """A recurrent or spectral state after a step with ``old``'s rows where
    ``done``: every field of a recurrent state; all but a spectral state's
    last field (the stream phase or the ring's step), which advances
    globally."""
    rows = len(new) if isinstance(new, RECURRENT_STATES) else len(new) - 1
    fields = [o if n is o else torch.where(_rows_mask(done, n), o, n) for o, n in zip(old[:rows], new[:rows])]
    return type(new)(*fields, *new[rows:])


def _put_rows(buf: torch.Tensor, new: torch.Tensor, slot: int) -> torch.Tensor:
    """``buf`` with rows ``slot`` … ``slot + len(new) − 1`` replaced by
    ``new`` (a new tensor; the state it came from is left as it was)."""
    n = new.shape[0]
    if buf.shape[1:] != new.shape[1:] or not 0 <= slot <= buf.shape[0] - n:
        raise faults.ServeError(
            f"cannot insert rows of shape {tuple(new.shape)} at slot {slot} of a state of shape "
            f"{tuple(buf.shape)}"
        )
    return torch.cat([buf[:slot], new.to(buf.dtype), buf[slot + n:]])


class Engine:
    """The serving phases of one :class:`DecoderLM` (on its device, at its
    config's compute dtype)."""

    def __init__(self, model, serve_cfg: ServeConfig = ServeConfig()):
        self.model = model
        self.cfg = model.cfg
        self.scfg = serve_cfg

    def generator(self, seed: int) -> torch.Generator:
        """A sampling stream on the model's device."""
        return torch.Generator(device=self.model.device).manual_seed(seed)

    def _sample(self, logits, generator):
        return sample(logits, temperature=self.scfg.temperature, top_k=self.scfg.top_k,
                      top_p=self.scfg.top_p, generator=generator)

    # -- prefill phase -----------------------------------------------------

    @torch.no_grad()
    def prefill(self, prompts, *, max_len: int, generator: torch.Generator) -> PrefillResult:
        """Run one request's prompt (B, S) → :class:`PrefillResult` whose
        caches are laid out for a ``max_len``-slot decode state."""
        faults.maybe_fail("serve.prefill", max_len=max_len)
        require_token_prompts(self.cfg)
        prompts = torch.as_tensor(prompts, dtype=torch.long, device=self.model.device)
        b, s = prompts.shape
        # The request's root span: every span inside carries its id.
        with tracing.request(), tracing.span("serve.prefill", prompt_len=s):
            logits, caches = self.model.prefill(prompts)
            with tracing.span("serve.decode_layout"):
                caches = self.model.prepare_decode_caches(caches, max_len)
            with tracing.span("serve.sample"):
                token = self._sample(logits, generator)
            return PrefillResult(
                caches=caches,
                token=token,
                length=torch.full((b,), s, dtype=torch.long, device=prompts.device),
            )

    # -- batch state -------------------------------------------------------

    def init_state(self, batch: int, max_len: int, generator: Optional[torch.Generator] = None) -> DecodeState:
        """An empty ``batch``-slot decode state (every slot done)."""
        dev = self.model.device
        return DecodeState(
            caches=self.model.cache_init(batch, max_len),
            tokens=torch.zeros(batch, dtype=torch.long, device=dev),
            lengths=torch.zeros(batch, dtype=torch.long, device=dev),
            done=torch.ones(batch, dtype=torch.bool, device=dev),
            generator=generator if generator is not None else self.generator(self.scfg.seed),
        )

    # -- insert phase ------------------------------------------------------

    @torch.no_grad()
    def insert(self, state: DecodeState, pres: PrefillResult, slot: int) -> DecodeState:
        """Splice ``pres`` (batch 1, or k consecutive slots) into ``state``
        starting at ``slot``.  Needs stream-mode spectral states: the ring
        layout's shared step counter cannot hold per-slot timelines."""
        faults.maybe_fail("serve.insert")
        if any(isinstance(live, SpectralCache) for live in state.caches):
            raise faults.ServeError(
                "insert needs spectral_decode_mode='stream' (the ring cache keeps one global "
                "step counter and cannot join a running batch)"
            )
        caches = []
        for block, live, new in zip(self.model.stack, state.caches, pres.caches, strict=True):
            if isinstance(live, SpectralStreamCache):
                # Re-align the fresh request to the running window's phase.
                new = block.mixer.stream_rephase(new, live.phase)
                caches.append(SpectralStreamCache(
                    *(_put_rows(a, b, slot) for a, b in zip(live[:3], new[:3])), phase=live.phase))
            elif isinstance(live, RECURRENT_STATES):
                caches.append(type(live)(*(_put_rows(a, b, slot) for a, b in zip(live, new, strict=True))))
            else:
                caches.append(attn_lib.KVCache(
                    *(None if a is None else _put_rows(a, b, slot) for a, b in zip(live, new))))
        return DecodeState(
            caches=caches,
            tokens=_put_rows(state.tokens, pres.token, slot),
            lengths=_put_rows(state.lengths, pres.length, slot),
            done=_put_rows(state.done, pres.token == self.scfg.eos_id, slot),
            generator=state.generator,
        )

    # -- decode phase ------------------------------------------------------

    def _step(self, st: DecodeState):
        rows = torch.arange(st.tokens.shape[0], device=st.tokens.device)
        # The KV slot each row writes this step, and its value before.
        written = []
        for block, cache in zip(self.model.stack, st.caches, strict=True):
            if isinstance(cache, attn_lib.KVCache):
                at = attn_lib.slot_index(st.lengths, cache.k.shape[1], block.mixer.window)
                bufs = [buf for buf in cache if buf is not None]
                written.append((at, bufs, [buf[rows, at] for buf in bufs]))
        logits, new = self.model.decode_step(st.tokens, st.caches, st.lengths)
        for at, bufs, olds in written:
            for buf, old in zip(bufs, olds):
                buf[rows, at] = torch.where(_rows_mask(st.done, old), old, buf[rows, at])
        caches = [n if isinstance(n, attn_lib.KVCache) else _keep_done_rows(st.done, o, n)
                  for o, n in zip(st.caches, new)]
        emit = torch.where(st.done, self.scfg.eos_id, self._sample(logits, st.generator))
        state = DecodeState(
            caches=caches,
            tokens=torch.where(st.done, st.tokens, emit),
            lengths=st.lengths + ~st.done,
            done=st.done | (emit == self.scfg.eos_id),
            generator=st.generator,
        )
        return state, emit

    @torch.no_grad()
    def decode(self, state: DecodeState, steps: int):
        """Run ``steps`` decode steps.  Returns (new_state, tokens (B, steps)
        int64 — ``eos_id`` for done slots).  KV caches of ``state`` are
        written in place."""
        faults.maybe_fail("serve.generate", steps=steps)
        emitted: List[torch.Tensor] = []
        for _ in range(steps):
            state, emit = self._step(state)
            emitted.append(emit)
        if not emitted:
            return state, state.tokens.new_zeros((state.tokens.shape[0], 0))
        return state, torch.stack(emitted, dim=1)

    # -- slot release ------------------------------------------------------

    def release(self, state: DecodeState, slot: int) -> DecodeState:
        """Mark ``slot`` done (deadline reaping, cancellation): its caches
        freeze and it emits ``eos_id`` until something is inserted over it,
        the state a naturally finished slot is left in."""
        done = state.done.clone()
        done[slot] = True
        return state._replace(done=done)

    # -- whole-batch convenience -------------------------------------------

    @torch.no_grad()
    def generate(self, prompts, *, max_new: Optional[int] = None) -> torch.Tensor:
        """prompts: (B, S) → (B, max_new) int64 generated tokens."""
        prompts = torch.as_tensor(prompts, dtype=torch.long, device=self.model.device)
        b, s = prompts.shape
        max_new = max_new or self.scfg.max_new
        gen = self.generator(self.scfg.seed)
        pres = self.prefill(prompts, max_len=s + max_new, generator=gen)
        first = pres.token
        if max_new == 1:
            return first[:, None]
        state = DecodeState(caches=pres.caches, tokens=first, lengths=pres.length,
                            done=first == self.scfg.eos_id, generator=gen)
        _, toks = self.decode(state, max_new - 1)
        return torch.cat([first[:, None], toks], dim=1)
