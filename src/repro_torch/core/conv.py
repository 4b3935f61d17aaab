"""FFT-based convolution: the engine's rfft/irfft pairs put to work.

Port of ``repro/core/conv.py``.  Long causal convolution (Hyena/S4-style
global filters, SAR matched filters) costs O(L²) direct but O(L log L) as
rfft → pointwise multiply → irfft, and every transform here goes through
:func:`repro_torch.core.fft.plan`, so on the card through the hand-written
kernels.  The math between the transforms (padding, the complex multiply,
slicing) is plain PyTorch on the tensor's device.

``device`` takes the place of the reference's ``backend=``: a tensor runs on
its own device, a host array goes to the card (and the call raises without
one), ``device="cpu"`` asks for the plain route.  Every function computes in
float32 and casts the result back to the input's dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from repro_torch.core import fft as fft_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core.fft_torch import cmul
from repro_torch.core.limits import next_pow2
from repro_torch.runtime import tracing

__all__ = [
    "fft_conv",
    "fft_conv2d",
    "fft_conv_packed",
    "next_pow2",
    "toeplitz_conv_ref",
]


def resolve_device(x, device=None) -> torch.device:
    """The device a convolution of ``x`` runs on: ``device`` when given,
    else the tensor's own, else the card (:func:`fft.plan`'s rule)."""
    if device is None and torch.is_tensor(x):
        device = x.device
    return fft_lib._resolve_device(device)


def as_signal(x, dev: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``dev``; a tensor already elsewhere is refused,
    as a plan refuses it."""
    if torch.is_tensor(x):
        if x.device != dev:
            raise fft_lib.PlanError(f"input is on {x.device}, the convolution runs on {dev}")
        return x
    return torch.as_tensor(np.asarray(x), device=dev)


def as_filter(h, dev: torch.device) -> torch.Tensor:
    """A filter as float32 on ``dev`` (moved there if it lives elsewhere)."""
    if torch.is_tensor(h):
        return h.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(h, np.float32), device=dev)


def pad_last(a: torch.Tensor, right: int, left: int = 0) -> torch.Tensor:
    """Zero-pad the last axis."""
    return tF.pad(a, (left, right)) if left or right else a


def empty_result(x: torch.Tensor, h: torch.Tensor, length: int, dtype) -> torch.Tensor:
    """The output of a convolution over an empty batch: the broadcast
    leading dims and ``length`` samples, with no transform run."""
    lead = torch.broadcast_shapes(x.shape[:-1], h.shape[:-1])
    return torch.zeros((*lead, length), dtype=dtype, device=x.device)


@tracing.span("conv.fft_conv")
def fft_conv(
    x,
    h,
    *,
    causal: bool = True,
    axis: int = -1,
    device=None,
    overlap_save: bool | None = None,
    tune: str | None = None,
    pad: str = "pow2",
) -> torch.Tensor:
    """Causal convolution of ``x`` with filter ``h`` along ``axis``.

    Zero-pads to the next power of two ≥ L + Lh − 1 (linear, not circular,
    convolution), transforms through one cached rfft/irfft plan pair,
    multiplies the spectra and keeps the first L samples (``causal``) or all
    L + Lh − 1 (``causal=False``).  ``pad="exact"`` transforms at exactly
    n = L + Lh − 1 instead, through the any-length rfft/irfft (a Bluestein
    child, and the recombination for an even n).

    ``overlap_save=None`` routes to
    :func:`repro_torch.core.overlap.fft_conv_os` when the padded length
    would leave the fused one-pass regime (n > ``FUSED_MAX``); ``True``
    forces overlap-save, ``False`` one shot.  ``tune`` is overlap-save's
    block decision (:mod:`repro_torch.core.tuning`): ``"off"`` the fixed
    heuristic, ``"model"`` (the default) the roofline's pick, ``"measure"``
    the measured winner.

    ``h`` is indexed over its last axis and broadcasts against ``x`` with the
    convolution axis moved last: per-channel filters (D, Lh) against
    (B, D, L), or against (B, S, D) with ``axis=1``.
    """
    if pad not in ("pow2", "exact"):
        raise ValueError(f"pad must be 'pow2' or 'exact', got {pad!r}")
    dev = resolve_device(x, device)
    x = as_signal(x, dev)
    L = x.shape[axis]
    Lh = h.shape[-1]
    n = L + Lh - 1 if pad == "exact" else next_pow2(L + Lh - 1)
    if pad == "pow2" and (overlap_save or (overlap_save is None and n > plan_lib.FUSED_MAX)):
        from repro_torch.core import overlap  # overlap builds on this module

        return overlap.fft_conv_os(x, h, causal=causal, axis=axis, device=dev, tune=tune)
    out_dtype = x.dtype
    x = x.to(torch.float32).movedim(axis, -1)
    h = as_filter(h, dev)
    L_out = L if causal else L + Lh - 1
    if x.numel() == 0:
        y = empty_result(x, h, L_out, out_dtype)
    else:
        fwd = fft_lib.plan(fft_lib.FFTSpec(n=n, kind="rfft"), device=dev)
        inv = fft_lib.plan(fft_lib.FFTSpec(n=n, kind="irfft"), device=dev)
        Xr, Xi = fwd(pad_last(x, n - L))
        Hr, Hi = fwd(pad_last(h, n - Lh))
        y = inv(cmul(Xr, Xi, Hr, Hi))[..., :L_out]
    return y.movedim(-1, axis).contiguous().to(out_dtype)


def toeplitz_conv_ref(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """O(L²) direct causal convolution oracle for tests (numpy).

    ``h`` broadcasts against ``x`` with the rule of :func:`fft_conv`: a 1-D
    filter applies to every row, per-channel filters broadcast over the
    leading axes.
    """
    L, Lh = x.shape[-1], h.shape[-1]
    hb = np.broadcast_to(h, x.shape[:-1] + (Lh,))
    flat_x = x.reshape(-1, L)
    flat_h = hb.reshape(-1, Lh)
    rows = [np.convolve(row, filt, mode="full")[:L] for row, filt in zip(flat_x, flat_h)]
    return np.stack(rows).reshape(x.shape)


@tracing.span("conv.fft_conv2d")
def fft_conv2d(x, h, *, mode: str = "same", device=None) -> torch.Tensor:
    """2-D linear convolution of real images: the SAR matched-filter path.

    ``x``: (..., H, W) real images; ``h``: a real filter broadcast over the
    leading axes (a (1, Wh) filter is a per-row matched filter, SAR range
    compression).  Both are zero-padded to powers of two covering the full
    linear convolution and go through ONE cached rfft2/irfft2 plan pair.
    ``mode="same"`` returns the leading (H, W) window, ``"full"`` the whole
    (H + Hh − 1, W + Wh − 1) convolution.
    """
    if mode not in ("same", "full"):
        raise ValueError(f"mode must be 'same' or 'full', got {mode!r}")
    dev = resolve_device(x, device)
    x = as_signal(x, dev)
    out_dtype = x.dtype
    H, W = x.shape[-2:]
    h = as_filter(h, dev)
    Hh, Wh = h.shape[-2:]
    rows, cols = (H, W) if mode == "same" else (H + Hh - 1, W + Wh - 1)
    if x.numel() == 0:
        lead = torch.broadcast_shapes(x.shape[:-2], h.shape[:-2])
        return torch.zeros((*lead, rows, cols), dtype=out_dtype, device=dev)
    N2 = next_pow2(H + Hh - 1)
    N = next_pow2(W + Wh - 1)
    fwd = fft_lib.plan(fft_lib.FFTSpec(n=N, kind="rfft2", n2=N2), device=dev)
    inv = fft_lib.plan(fft_lib.FFTSpec(n=N, kind="irfft2", n2=N2), device=dev)

    def pad2(a, hgt, wid):
        return tF.pad(a.to(torch.float32), (0, N - wid, 0, N2 - hgt))

    Xr, Xi = fwd(pad2(x, H, W))
    Hr, Hi = fwd(pad2(h, Hh, Wh))
    y = inv(cmul(Xr, Xi, Hr, Hi))
    return y[..., :rows, :cols].contiguous().to(out_dtype)


@tracing.span("conv.fft_conv_packed")
def fft_conv_packed(x, h, *, causal: bool = True, device=None) -> torch.Tensor:
    """Real-filter convolution with complex batch packing.

    Convolution with a real filter is linear over the reals, so rows 2b and
    2b + 1 of ``x`` (..., 2·B, L) convolve together as one complex signal:
    conv(x1 + i·x2, h) = conv(x1, h) + i·conv(x2, h), half the transforms of
    row by row.  An odd row count packs a zero row with the last one and
    strips it from the output.
    """
    dev = resolve_device(x, device)
    x = as_signal(x, dev)
    out_dtype = x.dtype
    x = x.to(torch.float32)
    h = as_filter(h, dev)
    twob, L = x.shape[-2], x.shape[-1]
    Lh = h.shape[-1]
    L_out = L if causal else L + Lh - 1
    if x.numel() == 0:
        return torch.zeros((*x.shape[:-1], L_out), dtype=out_dtype, device=dev)
    odd = twob % 2
    if odd:
        x = tF.pad(x, (0, 0, 0, 1))
    lead, rows = x.shape[:-2], twob + odd
    n = next_pow2(L + Lh - 1)
    fwd = fft_lib.plan(fft_lib.FFTSpec(n=n, kind="fft"), device=dev)
    inv = fft_lib.plan(fft_lib.FFTSpec(n=n, kind="ifft"), device=dev)
    rfwd = fft_lib.plan(fft_lib.FFTSpec(n=n, kind="rfft"), device=dev)
    Zr, Zi = fwd((pad_last(x[..., 0::2, :], n - L), pad_last(x[..., 1::2, :], n - L)))
    Hr, Hi = rfwd(pad_last(h, n - Lh))
    # The full-length Hermitian extension of the real filter's half-spectrum.
    m = n // 2
    Hr_f = torch.cat([Hr, torch.flip(Hr[..., 1:m], (-1,))], dim=-1)
    Hi_f = torch.cat([Hi, -torch.flip(Hi[..., 1:m], (-1,))], dim=-1)
    yr, yi = inv(cmul(Zr, Zi, Hr_f, Hi_f))
    out = torch.stack([yr, yi], dim=-2).reshape(*lead, rows, n)
    return out[..., :twob, :L_out].contiguous().to(out_dtype)
