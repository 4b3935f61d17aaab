"""Overlap-save convolution: long signals through small plans.

Port of ``repro/core/overlap.py``.  A one-shot :func:`~repro_torch.core.conv.fft_conv`
of a long signal pads to one transform past the fused one-pass regime;
overlap-save instead frames the signal into overlapping blocks of
``B = next_pow2(Lh)·OS_FACTOR`` (capped at ``FUSED_MAX``), runs ONE cached
rfft/irfft plan pair over all blocks with the filter's spectrum computed
once and broadcast, and keeps each block's valid tail.

:class:`StreamingConv` carries the ``Lh − 1`` overlap tail as explicit state,
so chunked calls (serving decode, SAR strip ingest) compose to the one-shot
result, ragged last chunks and chunks shorter than the filter included.

With ``block=None`` the block is a tuned decision
(:func:`repro_torch.core.tuning.tuned_block`), as in the reference:
``tune="off"`` keeps :func:`pick_block`'s heuristic, ``"model"`` (the
default) the roofline's modelled minimum, ``"measure"`` the winner timed
once per (device, L, Lh, batch) and kept in the persistent cache.

``StreamingConv(spmd=True)`` takes the block from the shape alone
(:func:`repro_torch.core.tuning.modeled_block`: no cache, no measurement),
so every rank of a process group builds the same stream.  The distributed
overlap-save convolution is :func:`repro_torch.core.distributed.pconv_os_sharded`.

Deliberate difference from the reference: framing is ``F.pad`` and
``Tensor.unfold`` (a strided view, materialised once by the plan) where the
reference gathers.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import faults, tuning
from repro_torch.core import fft as fft_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core.conv import as_filter, as_signal, empty_result, pad_last, resolve_device
from repro_torch.core.fft_torch import cmul
from repro_torch.core.limits import OS_FACTOR, next_pow2

Planes = Tuple[torch.Tensor, torch.Tensor]

__all__ = [
    "OS_FACTOR",
    "pick_block",
    "frame_signal",
    "filter_spectrum",
    "conv_frames",
    "fft_conv_os",
    "stream_lookahead",
    "StreamingConv",
]


def pick_block(filter_len: int, block: Optional[int] = None) -> int:
    """The fixed-heuristic overlap-save block for a ``filter_len``-tap filter.

    Default: ``next_pow2(filter_len) · OS_FACTOR``, capped at ``FUSED_MAX``
    so no planned transform leaves the one-pass regime; a filter too long
    for the cap to leave room gets twice its padded length instead.
    ``block`` overrides (a power of two > filter_len − 1, so each block
    yields at least one valid sample).
    """
    if filter_len < 1:
        raise faults.PlanError(f"filter must have at least one tap, got {filter_len}")
    p = next_pow2(filter_len)
    if block is not None:
        if block <= 0 or block & (block - 1):
            raise faults.PlanError(f"block must be a power of two, got {block}")
        if block <= filter_len - 1:
            raise faults.PlanError(
                f"block={block} leaves no valid samples for a "
                f"{filter_len}-tap filter (needs block > {filter_len - 1})"
            )
        return block
    return max(min(p * OS_FACTOR, plan_lib.FUSED_MAX), 2 * p, 2)


def _resolve_block(filter_len: int, block: Optional[int], L: int, batch: int, device,
                   tune: Optional[str], chunk: Optional[int] = None) -> int:
    """The block an overlap-save call uses: an explicit ``block`` is
    validated and wins; otherwise the tuner decides for a ``(batch, L)``
    signal on ``device`` (``"off"`` or a one-tap filter: :func:`pick_block`).
    ``chunk`` keys the decision to a streaming call grain."""
    if block is not None:
        return pick_block(filter_len, block)
    mode = tuning.resolve_mode(tune)
    if mode == "off" or filter_len < 2:
        return pick_block(filter_len)
    return tuning.tuned_block(L, filter_len, batch, device, mode, chunk=chunk)


def frame_signal(x: torch.Tensor, block: int, step: int, num_blocks: int) -> torch.Tensor:
    """Overlap-save framing of the last axis: ``(..., num_blocks, block)``.

    Left-pads ``block − step`` zeros (the first block's causal history),
    right-pads to ``overlap + num_blocks·step`` samples and takes the
    windows ``[j·step, j·step + block)`` as a strided view (``unfold``).
    """
    overlap = block - step
    pad_r = num_blocks * step - x.shape[-1]
    if pad_r < 0:
        raise faults.PlanError(
            f"{num_blocks} blocks of step {step} cover only "
            f"{num_blocks * step} < {x.shape[-1]} samples"
        )
    return pad_last(x, pad_r, overlap).unfold(-1, block, step)


def filter_spectrum(h, block: int, device=None) -> Planes:
    """Half-spectrum of ``h`` zero-padded to ``block``, with a broadcast block
    axis inserted before the bins: (..., 1, block/2 + 1) planes."""
    dev = resolve_device(h, device)
    h = as_filter(h, dev)
    fwd = fft_lib.plan(fft_lib.FFTSpec(n=block, kind="rfft"), device=dev)
    Hr, Hi = fwd(pad_last(h, block - h.shape[-1]))
    return Hr.unsqueeze(-2), Hi.unsqueeze(-2)


def conv_frames(frames: torch.Tensor, Hr, Hi, *, overlap: int) -> torch.Tensor:
    """Circular convolution of ``(..., nb, B)`` frames with the broadcast
    filter spectrum through one cached rfft/irfft pair, keeping each frame's
    valid tail: ``(..., nb, B − overlap)``.  Empty frames run nothing."""
    block = frames.shape[-1]
    if frames.numel() == 0:
        lead = torch.broadcast_shapes(frames.shape[:-1], Hr.shape[:-1])
        return frames.new_zeros((*lead, block - overlap), dtype=torch.float32)
    fwd = fft_lib.plan(fft_lib.FFTSpec(n=block, kind="rfft"), device=frames.device)
    inv = fft_lib.plan(fft_lib.FFTSpec(n=block, kind="irfft"), device=frames.device)
    Fr, Fi = fwd(frames)
    y = inv(cmul(Fr, Fi, Hr, Hi))
    return y[..., overlap:]


def fft_conv_os(
    x,
    h,
    *,
    causal: bool = True,
    axis: int = -1,
    block: Optional[int] = None,
    device=None,
    tune: Optional[str] = None,
) -> torch.Tensor:
    """Overlap-save convolution of ``x`` with ``h`` along ``axis``.

    Matches :func:`repro_torch.core.conv.fft_conv` at tolerance while never
    planning a transform longer than the block (≤ ``FUSED_MAX`` by default).
    ``h`` broadcasts as in ``fft_conv``.  ``block=None``: the tuned block
    (``tune``, see the module docstring).
    """
    dev = resolve_device(x, device)
    x = as_signal(x, dev)
    out_dtype = x.dtype
    x = x.to(torch.float32).movedim(axis, -1)
    h = as_filter(h, dev)
    L, Lh = x.shape[-1], h.shape[-1]
    batch = math.prod(x.shape[:-1])
    B = _resolve_block(Lh, block, L, batch, dev, tune)
    overlap = Lh - 1
    step = B - overlap
    L_out = L if causal else L + Lh - 1
    if x.numel() == 0:
        y = empty_result(x, h, L_out, out_dtype)
    else:
        nb = -(-L_out // step)
        Hr, Hi = filter_spectrum(h, B, dev)
        tails = conv_frames(frame_signal(x, B, step, nb), Hr, Hi, overlap=overlap)
        y = tails.reshape(*tails.shape[:-2], nb * step)[..., :L_out]
    return y.movedim(-1, axis).contiguous().to(out_dtype)


def _stream_conv(xin: torch.Tensor, Hr, Hi, *, block: int, overlap: int) -> torch.Tensor:
    """``conv(xin)[..., overlap:]``: the causal conv of ``xin`` (its carried
    history prefix included) through the cached block plan, keeping only
    the outputs past the history.  When everything fits one block (a decode
    flush of tail + chunk) this is a single padded frame."""
    L = xin.shape[-1]
    if L <= block:
        frames = pad_last(xin, block - L).unsqueeze(-2)
        return conv_frames(frames, Hr, Hi, overlap=overlap)[..., 0, : L - overlap]
    step = block - overlap
    nb = -(-L // step)
    tails = conv_frames(frame_signal(xin, block, step, nb), Hr, Hi, overlap=overlap)
    y = tails.reshape(*tails.shape[:-2], nb * step)
    return y[..., overlap:L]


def stream_lookahead(tail: torch.Tensor, Hr, Hi, *, window: int, block: int) -> torch.Tensor:
    """History-only contributions for the next ``window`` stream positions.

    ``tail``: (..., Lh − 1), the carried overlap state.  Entry ``i`` of the
    (..., window) result is what the causal conv emits at the ``i``-th
    upcoming position if every upcoming input is zero, Σ_{j>i} h[j]·x[t−j]:
    the flush primitive of the amortized spectral decode.  ``Hr``/``Hi``
    are :func:`filter_spectrum` planes at ``block``.
    """
    zeros = tail.new_zeros((*tail.shape[:-1], window), dtype=torch.float32)
    xin = torch.cat([tail.to(torch.float32), zeros], dim=-1)
    return _stream_conv(xin, Hr, Hi, block=block, overlap=tail.shape[-1])


class StreamingConv:
    """Chunked causal convolution with the overlap tail as explicit state.

    The streaming form of :func:`fft_conv_os` for serving decode and SAR
    strip ingest; the object stays immutable (state in, state out)::

        sc = StreamingConv(h)
        state = sc.init_state(x.shape[:-1])
        y1, state = sc(x[..., :4096], state)
        y2, state = sc(x[..., 4096:], state)
        # torch.cat([y1, y2], -1) == fft_conv_os(x, h)

    The block is fixed at construction and the filter's spectrum is
    computed here once: per-chunk work is the chunk's own frames.  With
    ``block=None`` the block is tuned as :func:`fft_conv_os`'s; ``chunk_hint``
    is the expected chunk length, to which the decision is keyed (its
    measurement times chunk calls); without it the tuner models a long
    ingest of 8 heuristic blocks.  ``device``: as the convolutions' (the
    filter tensor's own device, the card for a host array).

    ``spmd=True`` makes the block pick cache- and measurement-free
    (:func:`~repro_torch.core.tuning.modeled_block`): every rank of a
    process group derives the same block from the shape alone, where a
    per-rank cache hit or timing could differ and desynchronise the ranks'
    shapes, the rule :func:`~repro_torch.core.distributed.pconv_os_sharded`
    follows.
    """

    def __init__(
        self,
        h,
        *,
        block: Optional[int] = None,
        device=None,
        tune: Optional[str] = None,
        chunk_hint: Optional[int] = None,
        spmd: bool = False,
    ):
        self.device = resolve_device(h, device)
        self.h = as_filter(h, self.device)
        self.filter_len = int(self.h.shape[-1])
        self.overlap = self.filter_len - 1
        self.chunk_hint = chunk_hint
        L_tune = chunk_hint or 8 * pick_block(self.filter_len)
        if spmd and block is None:
            self.block = tuning.modeled_block(L_tune, self.filter_len, 1, self.device, chunk=chunk_hint)
        else:
            self.block = _resolve_block(self.filter_len, block, L_tune, 1, self.device, tune, chunk=chunk_hint)
        self._Hr, self._Hi = filter_spectrum(self.h, self.block, self.device)

    def init_state(self, lead: tuple = (), dtype=torch.float32) -> torch.Tensor:
        """Zero history, ``(*lead, Lh − 1)``, on the filter's device."""
        return torch.zeros((*tuple(lead), self.overlap), dtype=dtype, device=self.device)

    def _check_state(self, state: torch.Tensor) -> None:
        if state.shape[-1] != self.overlap:
            raise faults.PlanError(
                f"state carries {state.shape[-1]} samples, filter needs {self.overlap}"
            )

    def __call__(self, x, state: torch.Tensor) -> tuple:
        """Convolve one chunk; returns ``(y, new_state)``, ``y`` the causal
        output for exactly this chunk's samples."""
        x = as_signal(x, self.device)
        out_dtype = x.dtype
        self._check_state(state)
        xin = torch.cat([state.to(torch.float32), x.to(torch.float32)], dim=-1)
        y = _stream_conv(xin, self._Hr, self._Hi, block=self.block, overlap=self.overlap)
        # The last Lh − 1 inputs, with explicit lengths (a zero-length tail
        # for a one-tap filter).
        new_state = xin.narrow(-1, xin.shape[-1] - self.overlap, self.overlap).contiguous()
        return y.to(out_dtype), new_state

    def lookahead(self, state: torch.Tensor, window: int) -> torch.Tensor:
        """History-only outputs for the next ``window`` positions (see
        :func:`stream_lookahead`)."""
        self._check_state(state)
        return stream_lookahead(state, self._Hr, self._Hi, window=window, block=self.block)
