"""Pass kernels of the split regime (n > 65536) and of the 2-D programs.

``cols_pass_call`` — CUDA kernel in ``csrc/pencil.cu`` (engine
``csrc/radix.cuh``), replacing the TPU kernel ``cols_pass_call``
(``src/repro/kernels/pencil.py:102``): on an (R, f, s) view, a length-f
FFT down the middle axis of every column, times the inter-factor twiddle
``T[k, c]`` (an (f, s) LUT streamed once).  ``tw_every`` is the
width-broadcast mode of a strip-mined 2-D column program: the twiddle is an
(f, s / tw_every) grid whose column ``c // tw_every`` serves a run of
``tw_every`` image columns, for any image width (a power of two by shift,
any other by division).  ``s`` may be any width (an rfft2 half-spectrum is
m + 1 columns): the last chunk of columns is masked, with no padded copy.

``rows_natural_call`` — CUDA kernel in ``csrc/pencil.cu`` (engine
``csrc/radix.cuh``), replacing ``rows_natural_call``
(``src/repro/kernels/pencil.py:178``): on a (B, p, f) view, a length-f FFT
of every row written transposed to (B, f, p), so the program's output lands
in natural order with no transpose pass.

``cols_natural_call`` — CUDA kernel in ``csrc/pencil.cu`` (engine
``csrc/radix.cuh``), replacing ``cols_natural_call``
(``src/repro/kernels/pencil.py:234``): on a (B, P, f, w) view, a length-f
FFT down axis 2, written as (B, f, P, w) — the n2-axis digit transpose of
a strip-mined column program fused into the write.  It runs the column
engine of ``cols_pass`` over the (B·P, f, w) view with no twiddle; only
the store differs (output rows a stride P·w apart, each group at its own
base).

All three are radix FFTs, as ``dft_matmul`` and ``fft4step`` are since
their redesign: they read the (f,) roots table of the direction
(:func:`repro_torch.core.twiddle.roots`) and apply the inverse's 1/f at
the store.  A block transforms one on-chip tile of 2^t / f adjacent
columns (rows), t = 12, 13 or 14, each point read once and written once,
or runs the four-step f = n1·n2 for 8 adjacent columns (rows) through a
global scratch slab (two round trips); :data:`COLS_TILE` (both column
passes) and :data:`ROWS_TILE` pick the form per f (the slab from 4096
points).

``rfft_recomb_call`` / ``irfft_recomb_call`` — CUDA kernels in
``csrc/recomb.cu``, replacing ``rfft_recomb_call`` / ``irfft_recomb_call``
(``src/repro/kernels/pencil.py:313`` / ``:324``, both through
``_recomb_call`` at ``:284``): the Hermitian even/odd recombination of the
real-FFT packing, (B, m) ↔ (B, m + 1), one thread per output element.
They are bound by bytes.

Each ``*_plain`` function is the same computation in plain PyTorch; each
``*_call`` takes it for a CPU tensor, and for a CUDA tensor launches the
kernel or raises.  The kernels write a new output rather than the
reference's in-place update.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import fake, fft_torch
from repro_torch.core import plan as plan_lib
from repro_torch.core.fft_torch import cmul, stockham_fft
from repro_torch.core.faults import PlanError
from repro_torch.kernels import build

__all__ = [
    "COUNTS",
    "FORMS",
    "form_fits",
    "form_smem_bytes",
    "table_form",
    "cols_pass_plain",
    "cols_pass_call",
    "cols_natural_plain",
    "cols_natural_call",
    "rows_natural_plain",
    "rows_natural_call",
    "rfft_recomb_plain",
    "rfft_recomb_call",
    "irfft_recomb_plain",
    "irfft_recomb_call",
]

#: Kernel launches and plain-version calls, counted where each happens.
COUNTS = {
    "cols_pass": 0,
    "cols_pass_plain": 0,
    "rows_natural": 0,
    "rows_natural_plain": 0,
    "cols_natural": 0,
    "cols_natural_plain": 0,
    "rfft_recomb": 0,
    "rfft_recomb_plain": 0,
    "irfft_recomb": 0,
    "irfft_recomb_plain": 0,
}

#: The form of the column passes and of ``rows_natural`` by log2 f: log2 of the
#: on-chip tile's points (12, 13 or 14; the tile holds 2^t / f signals), or
#: :data:`SLAB`, the four-step through the scratch slab.  Each entry is the
#: form measured fastest on the H100 at the lengths the programs give the
#: kernels (PERF.md, ``scripts/kernel_ab.py --forms``): the 2^13 tile at
#: f = 512 and 1024 (shorter lengths, unmeasured, take it too), the 2^14
#: tile at 2048 (8 signals), and the slab from 4096, where an on-chip tile
#: holds fewer than 8 signals and its strided accesses split sectors.
SLAB = 0
COLS_TILE = {**{lg: 13 for lg in range(0, 11)}, 11: 14, **{lg: SLAB for lg in range(12, 17)}}
ROWS_TILE = {**{lg: 13 for lg in range(1, 11)}, 11: 14, **{lg: SLAB for lg in range(12, 17)}}

#: The longest column or row the radix passes take; the slab form's range
#: of each four-step factor and its shortest length (each phase's
#: 8192-point tiles hold whole groups of 8 signals and cover the phase).
MAX_F = 65536
SLAB_FACTORS = (8, 1024)
SLAB_MIN_F = 1024

#: Columns (rows) per block of the slab form: one 32-byte sector per plane.
SLAB_GROUP = 8

#: Every form a column or row pass can take, smallest first: the on-chip
#: tiles of 2^12, 2^13 and 2^14 points, then the slab.  The tuner's
#: candidates for a pass are the table's form and its neighbours here.
FORMS = (12, 13, 14, SLAB)

#: log2 of the points of the slab form's on-chip tiles (radix.cuh SL_LGM).
SLAB_TILE = 13


def table_form(kernel: str, f: int) -> int:
    """The form :data:`COLS_TILE` (the column passes) or :data:`ROWS_TILE`
    (``rows_natural``) gives a length-f pass."""
    return (ROWS_TILE if kernel == "rows_natural" else COLS_TILE)[f.bit_length() - 1]


def form_fits(f: int, form: int) -> bool:
    """Whether a length-f pass can run in ``form``: an on-chip tile holds at
    least one whole signal; the slab's four-step factors lie in
    :data:`SLAB_FACTORS`."""
    if form == SLAB:
        return SLAB_MIN_F <= f <= MAX_F
    return form in FORMS and f <= 1 << form


def form_smem_bytes(form: int) -> int:
    """Shared memory one block of ``form`` takes: the exchange buffer of its
    tile, both planes padded by one word per 32 (radix.cuh
    ``radix_smem_bytes``)."""
    m = 1 << (SLAB_TILE if form == SLAB else form)
    return 2 * (m + (m >> 5)) * 4

_P = build.PTR
_I = build.I64
_COLS = (_I,) * 7 + (_P,) * 11
_ROWS = (_I,) * 6 + (_P,) * 9
_NATURAL = (_I,) * 7 + (_P,) * 9
_RECOMB = (_I,) * 2 + (_P,) * 7


def _check_tw_every(s: int, tw_every: int) -> None:
    if tw_every < 1 or s % tw_every:
        raise PlanError(f"cols_pass: tw_every={tw_every} must divide the width {s}")


def _check_radix(name, xr, xi, x_shape, rr, ri, f, n1, twiddle=None, tw_shape=None, tile=None):
    """The radix passes' operands: a power-of-two f up to :data:`MAX_F`
    (rows: at least 2), its (f,) roots table, a slab factor n1 (0: the
    balanced split) whose two factors lie in :data:`SLAB_FACTORS`, a form
    (None: the table's) that fits f; the input planes of shape
    ``x_shape``."""
    least = 2 if name == "rows_natural" else 1
    if f < least or f & (f - 1) or f > MAX_F:
        raise PlanError(f"{name}: length {f} is not a power of two from {least} to {MAX_F}")
    lo, hi = SLAB_FACTORS
    if n1 and (n1 & (n1 - 1) or not lo <= n1 <= hi or not lo <= f // n1 <= hi):
        raise PlanError(f"{name}: n1={n1} is not a power-of-two factor of f={f} "
                        f"with both factors from {lo} to {hi}")
    if tile is not None and not form_fits(f, tile):
        raise PlanError(f"{name}: form {tile} does not fit length {f}; one of {FORMS}")
    ops = {"xr": (xr, x_shape), "xi": (xi, x_shape), "rr": (rr, (f,)), "ri": (ri, (f,))}
    if twiddle is not None:
        ops.update(tr=(twiddle[0], tw_shape), ti=(twiddle[1], tw_shape))
    build.check_planes(name, xr, **ops)
    if xr.device.type not in ("cpu", "cuda"):
        raise PlanError(f"{name} runs on cuda or cpu tensors, got {xr.device}")


def _tile_for(table: dict, f: int, tile):
    return table[f.bit_length() - 1] if tile is None else tile


def _slab_split(f: int, n1: int, tile: int) -> int:
    """The four-step's n1 of the slab form (0 for an on-chip tile)."""
    return (n1 or plan_lib.balanced_split(f)[0]) if tile == SLAB else 0


def _scale(yr, yi, f: int, inverse: bool):
    if not inverse:
        return yr, yi
    s = np.float32(1.0 / f)
    return yr * s, yi * s


def cols_pass_plain(xr, xi, rr, ri, twiddle=None, *, inverse=False, tw_every: int = 1):
    """Plain PyTorch version of the column pass (any device): the radix-2
    Stockham FFT over the roots table down every column, the scale, the
    twiddle."""
    COUNTS["cols_pass_plain"] += 1
    r, f, s = xr.shape
    # (R, f, s) → (R·s, f): each column becomes a row.
    yr, yi = stockham_fft(xr.transpose(1, 2).reshape(r * s, f),
                          xi.transpose(1, 2).reshape(r * s, f), roots=(rr, ri))
    yr, yi = _scale(yr, yi, f, inverse)
    yr = yr.reshape(r, s, f).transpose(1, 2)
    yi = yi.reshape(r, s, f).transpose(1, 2)
    if twiddle is not None:
        twr, twi = twiddle
        if tw_every > 1:  # column c takes twiddle column c // tw_every
            twr = twr.repeat_interleave(tw_every, dim=1)
            twi = twi.repeat_interleave(tw_every, dim=1)
        yr, yi = cmul(yr, yi, twr, twi)  # bin k of column c ⊙ T[k, c]
    return yr.contiguous(), yi.contiguous()


def cols_pass_call(xr, xi, rr, ri, twiddle=None, *, n1: int = 0, inverse=False,
                   tw_every: int = 1, tile=None):
    """Strided-column transform pass: x (R, f, s) → y (R, f, s) with
    ``y[r, :, c] = FFT_f(x[r, :, c]) ⊙ T[:, c // tw_every]`` (scaled by 1/f
    for ``inverse``), f a power of two up to 65536.

    ``rr``, ``ri`` — the (f,) roots table of the direction; ``twiddle`` —
    the (f, s / tw_every) inter-factor grid as split planes, or None;
    ``n1`` — the planner's first factor, the four-step split of the slab
    form (0: the balanced split); ``tile`` — the form (one of
    :data:`FORMS`; None: :data:`COLS_TILE`'s), which the plain version
    has no use for.
    """
    r, f, s = xr.shape
    _check_tw_every(s, tw_every)
    _check_radix("cols_pass", xr, xi, (r, f, s), rr, ri, f, n1, twiddle, (f, s // tw_every), tile)
    if xr.device.type == "cpu" and not fake.is_fake(xr):
        return cols_pass_plain(xr, xi, rr, ri, twiddle, inverse=inverse, tw_every=tw_every)
    return _launch_cols(xr, xi, rr, ri, twiddle, inverse, n1, tw_every, tile)


@build.on_device
def _launch_cols(xr, xi, rr, ri, twiddle, inverse, n1=0, tw_every=1, tile=None):
    """The launch; ``tile`` (12, 13, 14: the on-chip tile's log2 points, or
    :data:`SLAB`) overrides :data:`COLS_TILE`'s form: a tuned plan's form,
    the tests' and the form sweep of ``scripts/kernel_ab.py``."""
    r, f, s = xr.shape
    tile = _tile_for(COLS_TILE, f, tile)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xi)
    if xr.numel() == 0:  # an empty batch: nothing to launch
        return yr, yi
    tr, ti = twiddle if twiddle is not None else (None, None)
    mr = mi = None
    if tile == SLAB:
        mr, mi = _slab(xr, r * -(-s // SLAB_GROUP) * SLAB_GROUP * f)
    if fake.launch("cols_pass", (xr, xi, rr, ri, tr, ti), (yr, yi), (mr, mi), twiddle=tr is not None):
        return yr, yi
    p = build.ptr
    rc = build.function("repro_cols_pass", _COLS)(
        r, f, s, tw_every, _slab_split(f, n1, tile), tile, int(inverse), p(rr), p(ri), p(xr), p(xi),
        p(tr), p(ti), p(yr), p(yi), p(mr), p(mi), build.stream_ptr(xr),
    )
    build.check(rc, "cols_pass")
    COUNTS["cols_pass"] += 1
    return yr, yi


def _slab(like, numel: int):
    """The slab form's scratch planes: f points per column (row) of each
    block's group."""
    return (torch.empty(numel, dtype=like.dtype, device=like.device),
            torch.empty(numel, dtype=like.dtype, device=like.device))


def cols_natural_plain(xr, xi, rr, ri, *, inverse=False):
    """Plain PyTorch version of the digit-transposing column pass (any
    device): the radix-2 Stockham FFT over the roots table down every
    column, the scale, the permute to (B, f, P, w)."""
    COUNTS["cols_natural_plain"] += 1
    b, pp, f, w = xr.shape
    # (B, P, f, w) → (B·P·w, f): each column becomes a row.
    yr, yi = stockham_fft(xr.transpose(2, 3).reshape(b * pp * w, f),
                          xi.transpose(2, 3).reshape(b * pp * w, f), roots=(rr, ri))
    yr, yi = _scale(yr, yi, f, inverse)
    yr = yr.reshape(b, pp, w, f).permute(0, 3, 1, 2)  # → (B, f, P, w)
    yi = yi.reshape(b, pp, w, f).permute(0, 3, 1, 2)
    return yr.contiguous(), yi.contiguous()


def cols_natural_call(xr, xi, rr, ri, *, n1: int = 0, inverse=False, tile=None):
    """Final column pass of a strip-mined 2-D program with the n2-axis digit
    transpose fused into its write: x (B, P, f, w) → y (B, f, P, w),
    ``y[b, k, p, :] = FFT_f(x[b, p, :, :], axis=0)[k]`` (scaled by 1/f for
    ``inverse``), f a power of two up to 65536.  ``rr``, ``ri``, ``n1`` and
    ``tile`` as :func:`cols_pass_call`'s."""
    b, pp, f, w = xr.shape
    _check_radix("cols_natural", xr, xi, (b, pp, f, w), rr, ri, f, n1, tile=tile)
    if xr.device.type == "cpu" and not fake.is_fake(xr):
        return cols_natural_plain(xr, xi, rr, ri, inverse=inverse)
    return _launch_cols_natural(xr, xi, rr, ri, inverse, n1, tile)


@build.on_device
def _launch_cols_natural(xr, xi, rr, ri, inverse, n1=0, tile=None):
    """The launch; ``tile`` as :func:`_launch_cols`' (:data:`COLS_TILE`)."""
    b, pp, f, w = xr.shape
    tile = _tile_for(COLS_TILE, f, tile)
    yr = torch.empty((b, f, pp, w), dtype=xr.dtype, device=xr.device)
    yi = torch.empty((b, f, pp, w), dtype=xr.dtype, device=xr.device)
    if xr.numel() == 0:  # an empty batch: nothing to launch
        return yr, yi
    mr = mi = None
    if tile == SLAB:
        mr, mi = _slab(xr, b * pp * -(-w // SLAB_GROUP) * SLAB_GROUP * f)
    if fake.launch("cols_natural", (xr, xi, rr, ri), (yr, yi), (mr, mi)):
        return yr, yi
    p = build.ptr
    rc = build.function("repro_cols_natural", _NATURAL)(
        b, pp, f, w, _slab_split(f, n1, tile), tile, int(inverse), p(rr), p(ri), p(xr), p(xi),
        p(yr), p(yi), p(mr), p(mi), build.stream_ptr(xr),
    )
    build.check(rc, "cols_natural")
    COUNTS["cols_natural"] += 1
    return yr, yi


def rows_natural_plain(xr, xi, rr, ri, *, inverse=False):
    """Plain PyTorch version of the transposed-write row pass (any device):
    the radix-2 Stockham FFT over the roots table, the scale, the
    transpose."""
    COUNTS["rows_natural_plain"] += 1
    b, p, f = xr.shape
    yr, yi = stockham_fft(xr.reshape(b * p, f), xi.reshape(b * p, f), roots=(rr, ri))
    yr, yi = _scale(yr, yi, f, inverse)
    yr = yr.reshape(b, p, f).transpose(1, 2).contiguous()
    yi = yi.reshape(b, p, f).transpose(1, 2).contiguous()
    return yr, yi


def rows_natural_call(xr, xi, rr, ri, *, n1: int = 0, inverse=False, tile=None):
    """Contiguous-row transform pass with the natural-order transpose fused
    into its write: x (B, p, f) → y (B, f, p), y[b, k, q] = FFT_f(x[b, q])[k]
    (scaled by 1/f for ``inverse``), f a power of two from 2 to 65536.
    ``rr``, ``ri``, ``n1`` and ``tile`` (None: :data:`ROWS_TILE`'s) as
    :func:`cols_pass_call`'s."""
    b, pp, f = xr.shape
    _check_radix("rows_natural", xr, xi, (b, pp, f), rr, ri, f, n1, tile=tile)
    if xr.device.type == "cpu" and not fake.is_fake(xr):
        return rows_natural_plain(xr, xi, rr, ri, inverse=inverse)
    return _launch_rows(xr, xi, rr, ri, inverse, n1, tile)


@build.on_device
def _launch_rows(xr, xi, rr, ri, inverse, n1=0, tile=None):
    """The launch; ``tile`` as :func:`_launch_cols`' (:data:`ROWS_TILE`)."""
    b, pp, f = xr.shape
    tile = _tile_for(ROWS_TILE, f, tile)
    yr = torch.empty((b, f, pp), dtype=xr.dtype, device=xr.device)
    yi = torch.empty((b, f, pp), dtype=xr.dtype, device=xr.device)
    if xr.numel() == 0:  # an empty batch: nothing to launch
        return yr, yi
    mr = mi = None
    if tile == SLAB:
        mr, mi = _slab(xr, b * -(-pp // SLAB_GROUP) * SLAB_GROUP * f)
    if fake.launch("rows_natural", (xr, xi, rr, ri), (yr, yi), (mr, mi)):
        return yr, yi
    p = build.ptr
    rc = build.function("repro_rows_natural", _ROWS)(
        b, pp, f, _slab_split(f, n1, tile), tile, int(inverse), p(rr), p(ri), p(xr), p(xi),
        p(yr), p(yi), p(mr), p(mi), build.stream_ptr(xr),
    )
    build.check(rc, "rows_natural")
    COUNTS["rows_natural"] += 1
    return yr, yi


# ---------------------------------------------------------------------------
# Hermitian recombination of the real-FFT packing
# ---------------------------------------------------------------------------


def _check_recomb(name, xr, xi, wr, wi, m):
    b, width = xr.shape
    if m < 1:
        raise PlanError(f"{name}: the packed spectrum needs m >= 1 points, got {m}")
    build.check_planes(
        name, xr, xr=(xr, (b, width)), xi=(xi, (b, width)), wr=(wr, (m + 1,)), wi=(wi, (m + 1,)),
    )
    if xr.device.type not in ("cpu", "cuda"):
        raise PlanError(f"{name} runs on cuda or cpu tensors, got {xr.device}")


def rfft_recomb_plain(zr, zi, wr, wi):
    """Plain PyTorch version of the forward recombination (any device)."""
    COUNTS["rfft_recomb_plain"] += 1
    return fft_torch.rfft_recomb(zr, zi, wr, wi)


def rfft_recomb_call(zr, zi, wr, wi):
    """Forward recombination pass: packed spectrum Z (B, m) → the m + 1
    real-FFT bins (B, m + 1).  ``wr/wi``: the (m + 1,) e^{−2πik/n} LUT
    (``twiddle.rfft_recomb_twiddle(n)``)."""
    m = zr.shape[-1]
    _check_recomb("rfft_recomb", zr, zi, wr, wi, m)
    if zr.device.type == "cpu" and not fake.is_fake(zr):
        return rfft_recomb_plain(zr, zi, wr, wi)
    return _launch_recomb(zr, zi, wr, wi, "rfft_recomb", m, m + 1)


def irfft_recomb_plain(xr, xi, wr, wi):
    """Plain PyTorch version of the inverse recombination (any device)."""
    COUNTS["irfft_recomb_plain"] += 1
    return fft_torch.irfft_recomb(xr, xi, wr, wi)


def irfft_recomb_call(xr, xi, wr, wi):
    """Inverse recombination pass: bins (B, m + 1) → packed spectrum Z
    (B, m).  ``wr/wi``: the (m + 1,) e^{+2πik/n} LUT
    (``twiddle.rfft_recomb_twiddle(n, inverse=True)``)."""
    m = xr.shape[-1] - 1
    _check_recomb("irfft_recomb", xr, xi, wr, wi, m)
    if xr.device.type == "cpu" and not fake.is_fake(xr):
        return irfft_recomb_plain(xr, xi, wr, wi)
    return _launch_recomb(xr, xi, wr, wi, "irfft_recomb", m, m)


@build.on_device
def _launch_recomb(xr, xi, wr, wi, name, m, width):
    b = xr.shape[0]
    yr = torch.empty((b, width), dtype=xr.dtype, device=xr.device)
    yi = torch.empty((b, width), dtype=xr.dtype, device=xr.device)
    if xr.numel() == 0:  # an empty batch: nothing to launch
        return yr, yi
    if fake.launch(name, (xr, xi, wr, wi), (yr, yi)):
        return yr, yi
    p = build.ptr
    rc = build.function(f"repro_{name}", _RECOMB)(
        b, m, p(xr), p(xi), p(wr), p(wi), p(yr), p(yi), build.stream_ptr(xr),
    )
    build.check(rc, name)
    COUNTS[name] += 1
    return yr, yi
