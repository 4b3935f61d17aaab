"""Spectral mixer: the engine's FFT as an LM layer (Hyena-style long conv).

Port of ``repro/models/layers/spectral.py`` as an ``nn.Module``.  Token
mixing is a causal convolution with a learned per-channel global filter,
computed as rfft → pointwise → irfft through
:func:`repro_torch.core.conv.fft_conv` (so on the card through the
hand-written kernels), gated by ``silu(x @ w_gate)``.  The D×D projections
are ``x @ w`` with ``w`` in the reference's (in, out) layout.

Decode has two exactly-equivalent state layouts:

* **stream** (:meth:`SpectralMixer.stream_decode`, the serving path): the
  overlap-save tail, a chunk accumulator and a precomputed lookahead (the
  history-only half of the next C outputs), refreshed once per C tokens by
  one cached block-plan conv (:func:`repro_torch.core.overlap.stream_lookahead`).
  Per token only the direct head, taps ``j ≤ phase`` against the chunk.
* **ring** (:meth:`SpectralMixer.decode`): a ring buffer of the last Lf
  inputs and the O(Lf·D) direct dot per token, the exactness oracle.

The decode position (``phase``, ``t``) is a Python int, so a token's flush
decision never reads the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as tF
from torch import nn

from repro_torch.core import fft as fft_lib
from repro_torch.core import overlap as ov_lib
from repro_torch.core.conv import fft_conv
from repro_torch.core.limits import next_pow2
from repro_torch.sharding.shard import data_gather, local, model_copy, model_sum, own_rows, tp, ws_in
from repro_torch.utils.params import normal

__all__ = [
    "SpectralMixer",
    "SpectralCache",
    "SpectralStreamCache",
    "stream_grain",
    "stream_plan_info",
]

DECODE_MODES = ("stream", "ring")


class SpectralCache(NamedTuple):
    """Ring decode state: ``buf`` (B, Lf, D) float32 holds input position p
    at slot p % Lf; ``t`` is the next position."""

    buf: torch.Tensor
    t: int


class SpectralStreamCache(NamedTuple):
    """Streaming decode state; the window boundary B0 is the position where
    the current lookahead was computed.

    hist:   (B, D, Lf − 1 + C) the last Lf − 1 + C inputs before B0 (the
            trailing Lf − 1 feed flushes; the leading C let a new request be
            re-phased into a running batch, :meth:`SpectralMixer.stream_rephase`).
    chunk:  (B, D, C) inputs since B0 (slots [0, phase) live, the rest 0).
    future: (B, D, C) the history-only part of outputs B0 … B0 + C − 1.
    phase:  the next chunk slot to fill, in [0, C).
    """

    hist: torch.Tensor
    chunk: torch.Tensor
    future: torch.Tensor
    phase: int


def stream_grain(filter_len: int, decode_chunk: int = 0) -> Tuple[int, int]:
    """(chunk C, flush block) of the streaming decode state: C =
    ``decode_chunk`` or max(8, next_pow2(Lf)/4), and the smallest power of
    two holding one flush input (Lf − 1 + C samples), so each flush is a
    single frame through one cached rfft/irfft pair."""
    c = decode_chunk or max(8, next_pow2(filter_len) // 4)
    return c, next_pow2(max(filter_len - 1 + c, 2))


def stream_plan_info(cfg, batch: int = 1) -> dict:
    """The streaming decode's plan metadata for a ``ModelConfig``: the
    decode grain, the flush plan's schedule and the modelled HBM bytes of
    one flush at that grain (:func:`repro_torch.analysis.roofline.conv_report`),
    as the reference's."""
    from repro_torch.analysis import roofline as rl
    from repro_torch.core import plan as plan_lib

    lf = cfg.spectral_filter_len
    c, block = stream_grain(lf, cfg.spectral_decode_chunk)
    report = rl.conv_report(lf - 1 + c, lf, batch=batch, block=block)
    return {
        "filter_len": lf,
        "chunk": c,
        "block": block,
        "flushes_per_token": 1.0 / c,
        "flush_schedule": plan_lib.describe(block),
        "flush_hbm_bytes": report["overlap_save"]["hbm_bytes"],
    }


class SpectralMixer(nn.Module):
    """Gated FFT long-convolution token mixer, (B, S, D) → (B, S, D).

    Built from the four fields of the reference's ``ModelConfig`` it reads:
    ``d_model``, ``filter_len`` (``spectral_filter_len``), ``decode_chunk``
    (``spectral_decode_chunk``, 0 → sized from the filter) and
    ``decode_mode`` (``spectral_decode_mode``: the cache ``forward`` returns).
    Parameters: ``filt`` (D, Lf) float32 with the reference's decaying
    envelope, and ``w_gate``, ``w_in``, ``w_out`` (D, D) in ``dtype``, drawn
    from ``generator`` on its own device.  ``device=None`` puts them on the
    card (raising without one); ``device="cpu"`` runs the plain route.
    """

    def __init__(
        self,
        d_model: int,
        filter_len: int = 1024,
        *,
        decode_chunk: int = 0,
        decode_mode: str = "stream",
        dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if decode_mode not in DECODE_MODES:
            raise ValueError(f"decode_mode must be one of {DECODE_MODES}, got {decode_mode!r}")
        dev = fft_lib._resolve_device(device)
        self.d_model, self.filter_len = d_model, filter_len
        self.decode_chunk, self.decode_mode = decode_chunk, decode_mode
        D, Lf = d_model, filter_len
        # Smooth decaying filter: h[d, j] ~ N(0, 1/Lf) · exp(−j/τ_d).
        j = np.arange(Lf, dtype=np.float32)
        tau = np.logspace(1.0, np.log10(Lf), D, dtype=np.float32)
        at = generator.device if generator is not None else dev
        envelope = torch.from_numpy(np.exp(-j[None, :] / tau[:, None])).to(at)
        base = torch.randn(D, Lf, generator=generator, device=at) * Lf**-0.5
        self.filt = nn.Parameter((base * envelope).to(dev))
        kw = dict(dtype=dtype, device=dev, generator=generator)
        self.w_gate, self.w_in, self.w_out = normal((D, D), **kw), normal((D, D), **kw), normal((D, D), **kw)

    @property
    def grain(self) -> Tuple[int, int]:
        return stream_grain(self.filter_len, self.decode_chunk)

    def _channels(self) -> int:
        """This rank's channels: all of them unsharded, else its shard of
        the ff axis."""
        return local(self.w_in).shape[1]

    def _filt(self) -> torch.Tensor:
        """The filter rows of this rank's channels (no gradient path: the
        decode's)."""
        ch = self._channels()
        return self.filt if ch == self.d_model else self.filt.narrow(0, tp().rank * ch, ch)

    def _mix(self, y: torch.Tensor) -> torch.Tensor:
        """A decode step's output: the channel shards' partial sums met over
        ``model`` in a sharded model."""
        return y if self._channels() == self.d_model else model_sum(y)

    def _in_gate(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # Under a weight-stationary decode: this rank's embed slice, the
        # partial products summed over data.
        u, g = ws_in(x, self.w_in, self.w_gate)
        return u, tF.silu(g)

    def _out(self, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """The gated output projection; a weight-stationary decode's data
        shard of the rows (``y``'s, of the step's ``g``) gathered to the
        step's batch before ``w_out``."""
        cd = g.dtype
        h = y.to(cd) * own_rows(g, y.shape[0])
        if h.shape[0] != g.shape[0]:
            h = data_gather(h)
        return h @ self.w_out.to(cd)

    def forward(self, x: torch.Tensor, return_cache: bool = False):
        """x: (B, S, D) → (B, S, D), differentiable in ``x``, ``filt`` and
        the projections; with ``return_cache`` also the decode state after
        the prompt (ring or stream, by ``decode_mode``), built without a
        graph as every decode step is."""
        channels = self.w_in.shape[1]
        if channels != self.d_model:
            # A sharded model: this rank's channels of the ff axis, the
            # filter's rows of them, and the projections' partial sums.
            u, g = self._in_gate(model_copy(x))
            filt = model_copy(self.filt).narrow(0, tp().rank * channels, channels)
            out = model_sum(self._out(fft_conv(u.to(torch.float32), filt, axis=1), g))
        else:
            u, g = self._in_gate(x)
            # The conv runs along the sequence axis; fft_conv routes to
            # overlap-save past the fused regime.
            y = fft_conv(u.to(torch.float32), self.filt, axis=1)
            out = self._out(y, g)
        if not return_cache:
            return out
        with torch.no_grad():  # decode states carry no graph
            u32 = u.to(torch.float32)
            if self.decode_mode == "ring":
                return out, self._ring_state(u32)
            return out, self._stream_state(u32)

    # -- decode state after a prefill -------------------------------------

    def _ring_state(self, u32: torch.Tensor) -> SpectralCache:
        b, s, d = u32.shape  # d: this rank's channels
        lf = self.filter_len
        keep = min(lf, s)
        buf = u32.new_zeros((b, lf, d))
        slots = torch.as_tensor(np.arange(s - keep, s) % lf, device=u32.device)
        buf[:, slots, :] = u32[:, s - keep:, :]
        return SpectralCache(buf=buf, t=s)

    def _stream_state(self, u32: torch.Tensor) -> SpectralStreamCache:
        """Window boundary at the prompt's end S, an empty chunk, and the
        lookahead for the next C outputs.  Positions before 0 of a prompt
        shorter than Lf − 1 + C are zeros."""
        b, s, d = u32.shape
        c, _ = self.grain
        cap = self.filter_len - 1 + c
        uT = u32.movedim(1, 2)  # (B, D, S)
        hist = tF.pad(uT, (cap - s, 0)) if s < cap else uT[..., s - cap:].contiguous()
        return SpectralStreamCache(
            hist=hist, chunk=u32.new_zeros((b, d, c)), future=self._lookahead(hist[..., c:]), phase=0
        )

    def _lookahead(self, tail: torch.Tensor) -> torch.Tensor:
        """The history-only half of the next C outputs after ``tail`` (the
        last Lf − 1 inputs): one conv through the cached block plan, the
        filter's spectrum included; an empty batch runs nothing."""
        c, block = self.grain
        if tail.numel() == 0:
            return tail.new_zeros((*tail.shape[:-1], c))
        Hr, Hi = ov_lib.filter_spectrum(self._filt(), block)
        return ov_lib.stream_lookahead(tail, Hr, Hi, window=c, block=block)

    def init_cache(self, batch: int) -> SpectralCache:
        """Empty ring state."""
        return SpectralCache(
            buf=torch.zeros((batch, self.filter_len, self._channels()), device=self.filt.device), t=0
        )

    def init_stream_cache(self, batch: int) -> SpectralStreamCache:
        """Empty streaming state."""
        c, _ = self.grain
        cap = self.filter_len - 1 + c
        zeros = lambda w: torch.zeros((batch, self._channels(), w), device=self.filt.device)  # noqa: E731
        return SpectralStreamCache(hist=zeros(cap), chunk=zeros(c), future=zeros(c), phase=0)

    # -- decode -------------------------------------------------------------

    @torch.no_grad()
    def decode(self, x: torch.Tensor, cache: SpectralCache) -> Tuple[torch.Tensor, SpectralCache]:
        """One token (x: (B, 1, D)) through the ring: the direct dot of the
        filter with the last Lf inputs."""
        lf = self.filter_len
        u, g = self._in_gate(x)
        u = own_rows(u, cache.buf.shape[0])
        slot = cache.t % lf
        buf = cache.buf.clone()
        buf[:, slot, :] = u[:, 0].to(torch.float32)
        # Tap j multiplies the input j steps back, at slot (slot − j) mod Lf;
        # taps reaching before position 0 see nothing.
        taps = min(cache.t, lf - 1) + 1
        ages = (slot - torch.arange(taps, device=buf.device)) % lf
        y = torch.einsum("blD,Dl->bD", buf[:, ages, :], self._filt()[:, :taps])
        return self._mix(self._out(y[:, None, :], g)), SpectralCache(buf=buf, t=cache.t + 1)

    @torch.no_grad()
    def stream_decode(
        self, x: torch.Tensor, cache: SpectralStreamCache
    ) -> Tuple[torch.Tensor, SpectralStreamCache]:
        """One token (x: (B, 1, D)) through the streaming state.

        Output = ``future[phase]`` + the direct head Σ_{j≤phase}
        h[j]·chunk[phase − j], exactly Σ_j h[j]·u[t − j].  When the chunk
        fills (phase C − 1) the window advances: the tail shifts by C and one
        lookahead conv through the cached block plan precomputes the next
        window's history half.
        """
        c, _ = self.grain
        i = cache.phase
        u, g = self._in_gate(x)
        u = own_rows(u, cache.chunk.shape[0])
        chunk = cache.chunk.clone()
        chunk[..., i] = u[:, 0].to(torch.float32)
        k = min(i + 1, self.filter_len)  # taps past the filter are zero
        head = torch.flip(self._filt()[:, :k], (-1,))
        y = (chunk[..., i + 1 - k: i + 1] * head).sum(-1) + cache.future[..., i]
        out = self._mix(self._out(y[:, None, :], g))
        if i < c - 1:
            return out, cache._replace(chunk=chunk, phase=i + 1)
        hist = torch.cat([cache.hist[..., c:], chunk], dim=-1)
        return out, SpectralStreamCache(
            hist=hist, chunk=torch.zeros_like(chunk), future=self._lookahead(hist[..., c:]), phase=0
        )

    @torch.no_grad()
    def stream_rephase(self, cache: SpectralStreamCache, phase: int) -> SpectralStreamCache:
        """Re-align a freshly prefilled stream state (phase 0, boundary at its
        prompt end S) to a running batch's ``phase`` f in [0, C): the
        boundary moves back to S − f, the last f prompt inputs become live
        chunk slots, the tail is re-cut and one lookahead conv rebuilds
        ``future``; the leading ``hist`` slots the shift exposes are zeroed.
        """
        lf = self.filter_len
        c, _ = self.grain
        cap = lf - 1 + c
        f = int(phase)
        if not 0 <= f < c:
            raise ValueError(f"phase must lie in [0, {c}), got {f}")
        histp = tF.pad(cache.hist, (0, c))  # index m ↦ u[S − cap + m], zeros from cap
        tail = histp[..., c - f: c - f + lf - 1]
        live = (torch.arange(c, device=histp.device) < f).to(histp.dtype)
        chunk = histp[..., cap - f: cap - f + c] * live
        hist = torch.cat([histp.new_zeros((*histp.shape[:-1], c)), tail], dim=-1)
        return SpectralStreamCache(hist=hist, chunk=chunk, future=self._lookahead(tail), phase=f)
