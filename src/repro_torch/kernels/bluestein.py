"""Bluestein chirp-convolution stages: FFTs of any length.

Bluestein's identity jk = (j² + k² − (k−j)²)/2 turns a length-n DFT of any
n into one circular convolution at a power-of-two pad M ≥ 2n − 1.  The
planner (``core/plan.compile_bluestein``) schedules it as two passes while
M ≤ 65536 (the fused regime) and as seven beyond (the split regime: three
elementwise stages around M's own two-pass forward and inverse programs).

``bluestein_fwd_call`` — CUDA kernel in ``csrc/bluestein.cu`` (engine
``csrc/radix.cuh``), replacing the TPU kernel ``bluestein_fwd_call``
(``src/repro/kernels/bluestein.py:85``): x (B, n) → FFT_M(chirp·x ‖ 0) ⊙ B̂
(B, M).

``bluestein_inv_call`` — replacing ``bluestein_inv_call`` (``:142``):
x (B, M) → post·IFFT_M(x)[:, :n] (B, n), 1/M applied at the store and, for
an outer inverse, 1/n in ``post``.

``bluestein_elem_call`` — replacing ``bluestein_elem_call`` (``:197``): one
elementwise stage of the split regime, ``pre`` (B, n) → chirp·x padded to
(B, M), ``mul`` (B, M) ⊙ B̂, ``post`` (B, M) → post·x[:, :n] (B, n).

The fused stages are radix FFTs of the pad length, as ``fft4step``'s, bound
by bytes on the H100: the chirp and the zero pad are the forward's load
(the pad is never in memory and costs no read), B̂ its store; the inverse's
store keeps the first n bins times 1/M and the post-chirp.  Up to
M = 16384 a block holds whole signals on chip (one round trip); at
M = 32768 and 65536 it runs the planner's four-step M = n1 × n2 through a
global scratch slab (two).  Each reads one (M,) roots table: forward for
``fwd``, inverse for ``inv``, whatever the outer direction.  The
elementwise stage is bound by bytes too.  The kernels write a new output
where the reference's ``mul`` worked in place: writing in place would not
lower a split call's peak memory, since the pad length's column and row
passes around ``mul`` hold two (B, M) pairs too.

Each ``*_plain`` function is the same computation in plain PyTorch, from
:func:`~repro_torch.core.fft_torch.cmul` and
:func:`~repro_torch.core.fft_torch.stockham_fft` over the same roots
table; each ``*_call`` takes it for a CPU tensor, and for a CUDA tensor
launches the kernel or raises.  ``luts`` are 1-D planes
(``kernels/ops._bluestein_luts``): ``(chirp_r, chirp_i, *roots(M, fwd),
spec_r, spec_i)`` for ``fwd``, ``(*roots(M, inv), post_r, post_i)`` for
``inv`` and the stage's pair for ``elem``.
"""

from __future__ import annotations

import torch

from repro_torch.core import fake
from repro_torch.core import plan as plan_lib
from repro_torch.core.fft_torch import cmul, stockham_fft
from repro_torch.core.faults import PlanError
from repro_torch.kernels import build, dft_matmul, fft4step
from repro_torch.runtime import tracing

__all__ = [
    "COUNTS",
    "STAGES",
    "bluestein_fwd_plain",
    "bluestein_fwd_call",
    "bluestein_inv_plain",
    "bluestein_inv_call",
    "bluestein_elem_plain",
    "bluestein_elem_call",
    "slab_split",
]

#: Kernel launches and plain-version calls, counted where each happens.
COUNTS = {
    "bluestein_fwd": 0,
    "bluestein_fwd_plain": 0,
    "bluestein_inv": 0,
    "bluestein_inv_plain": 0,
    "bluestein_elem": 0,
    "bluestein_elem_plain": 0,
}

#: The elementwise stages of the split regime.
STAGES = ("pre", "mul", "post")

#: The longest pad of the fused stages.
MAX_M = 65536

_P = build.PTR
_I = build.I64
_FWD = (_I,) * 4 + (_P,) * 13
_INV = (_I,) * 4 + (_P,) * 11
_ELEM = (_I,) * 3 + (_P,) * 7


def _check(name, xr, xi, width, luts, lut_shapes):
    if len(luts) != len(lut_shapes):
        raise PlanError(f"{name} takes {len(lut_shapes)} LUT planes, got {len(luts)}")
    b = xr.shape[0]
    ops = {"xr": (xr, (b, width)), "xi": (xi, (b, width))}
    ops.update({f"lut{i}": (t, s) for i, (t, s) in enumerate(zip(luts, lut_shapes))})
    build.check_planes(name, xr, **ops)
    if xr.device.type not in ("cpu", "cuda"):
        raise PlanError(f"{name} runs on cuda or cpu tensors, got {xr.device}")


def _check_pad(name, n: int, m_pad: int):
    if n < 2 or m_pad & (m_pad - 1) or m_pad < 2 * n - 1:
        raise PlanError(f"{name}: pad M={m_pad} must be a power of two ≥ 2n − 1 = {2 * n - 1}")


def _check_fused(name, n: int, m_pad: int, in1: int) -> None:
    """A fused stage's pad (at most :data:`MAX_M`) and the slab form's
    first factor ``in1`` (0: the balanced split), whose two factors are
    ``fft4step``'s."""
    _check_pad(name, n, m_pad)
    if m_pad > MAX_M:
        raise PlanError(f"{name}: pad M={m_pad} is past the fused regime's {MAX_M}")
    lo = fft4step.MIN_FACTOR
    if in1 and (in1 & (in1 - 1) or in1 < lo or m_pad // in1 < lo):
        raise PlanError(f"{name}: in1={in1} is not a power-of-two factor of M={m_pad} "
                        f"with both factors at least {lo}")


def slab_split(like, m_pad: int, in1: int = 0) -> int:
    """The first factor of the slab form at pad ``m_pad`` on ``like``'s
    card (``in1``, or the balanced split), or 0 for the whole-signal tiles:
    the pad takes the form ``fft4step`` gives that length (a tile to 1024
    points, and to 16384 while the tile fits a block's shared memory)."""
    if m_pad <= dft_matmul.MAX_N or not fft4step.slab_needed(like, m_pad):
        return 0
    return in1 or plan_lib.balanced_split(m_pad)[0]


def _slab(xr, m_pad: int, in1: int):
    """(scratch planes of B·M points each, or None, None; the slab form's
    first factor, or 0)."""
    n1 = slab_split(xr, m_pad, in1)
    if not n1:
        return None, None, 0
    numel = xr.shape[0] * m_pad
    return (torch.empty(numel, dtype=xr.dtype, device=xr.device),
            torch.empty(numel, dtype=xr.dtype, device=xr.device), n1)


def bluestein_fwd_plain(xr, xi, luts, *, n: int, m_pad: int):
    """Plain PyTorch version of the forward stage (any device)."""
    COUNTS["bluestein_fwd_plain"] += 1
    cr, ci, rr, ri, br, bi = luts
    yr, yi = cmul(xr, xi, cr, ci)
    yr = torch.nn.functional.pad(yr, (0, m_pad - n))
    yi = torch.nn.functional.pad(yi, (0, m_pad - n))
    fr, fi = stockham_fft(yr, yi, roots=(rr, ri))
    return cmul(fr, fi, br, bi)


def bluestein_fwd_call(xr, xi, luts, *, n: int, m_pad: int, in1: int = 0):
    """Fused forward stage: x (B, n) → FFT_M(chirp·x ‖ 0) ⊙ B̂ (B, M).

    ``luts`` = (chirp_r, chirp_i, roots_r, roots_i, spec_r, spec_i): the
    (n,) pre-chirp, the (M,) forward roots table and the (M,) chirp
    spectrum B̂.  ``in1``: the planner's first factor of M, the four-step
    split of the slab form (0: the balanced split)."""
    _check_fused("bluestein_fwd", n, m_pad, in1)
    _check("bluestein_fwd", xr, xi, n, luts, [(n,)] * 2 + [(m_pad,)] * 4)
    if xr.device.type == "cpu" and not fake.is_fake(xr):
        return bluestein_fwd_plain(xr, xi, luts, n=n, m_pad=m_pad)
    return _launch_fwd(xr, xi, luts, n, m_pad, in1)


@tracing.span("kernel.bluestein_fwd")
@build.on_device
def _launch_fwd(xr, xi, luts, n, m_pad, in1=0):
    b = xr.shape[0]
    yr = torch.empty((b, m_pad), dtype=xr.dtype, device=xr.device)
    yi = torch.empty((b, m_pad), dtype=xr.dtype, device=xr.device)
    if xr.numel() == 0:  # an empty batch: nothing to launch
        return yr, yi
    mr, mi, n1 = _slab(xr, m_pad, in1)
    if fake.launch("bluestein_fwd", (xr, xi, *luts), (yr, yi), (mr, mi), n=n, m_pad=m_pad):
        return yr, yi
    p = build.ptr
    rc = build.function("repro_bluestein_fwd", _FWD)(
        b, n, m_pad, n1, p(xr), p(xi), *map(p, luts), p(yr), p(yi), p(mr), p(mi),
        build.stream_ptr(xr),
    )
    build.check(rc, "bluestein_fwd")
    COUNTS["bluestein_fwd"] += 1
    return yr, yi


def bluestein_inv_plain(xr, xi, luts, *, n: int, m_pad: int):
    """Plain PyTorch version of the inverse stage (any device)."""
    COUNTS["bluestein_inv_plain"] += 1
    rr, ri, pr, pi = luts
    gr, gi = stockham_fft(xr, xi, inverse=True, roots=(rr, ri))
    return cmul(gr[:, :n], gi[:, :n], pr, pi)


def bluestein_inv_call(xr, xi, luts, *, n: int, m_pad: int, in1: int = 0):
    """Fused inverse stage: x (B, M) → post·IFFT_M(x)[:, :n] (B, n).

    ``luts`` = (roots_r, roots_i, post_r, post_i): the (M,) inverse roots
    table (1/M is applied at the store) and the (n,) post-chirp (1/n folded
    in for an outer inverse).  ``in1`` as :func:`bluestein_fwd_call`'s."""
    _check_fused("bluestein_inv", n, m_pad, in1)
    _check("bluestein_inv", xr, xi, m_pad, luts, [(m_pad,)] * 2 + [(n,)] * 2)
    if xr.device.type == "cpu" and not fake.is_fake(xr):
        return bluestein_inv_plain(xr, xi, luts, n=n, m_pad=m_pad)
    return _launch_inv(xr, xi, luts, n, m_pad, in1)


@tracing.span("kernel.bluestein_inv")
@build.on_device
def _launch_inv(xr, xi, luts, n, m_pad, in1=0):
    b = xr.shape[0]
    yr = torch.empty((b, n), dtype=xr.dtype, device=xr.device)
    yi = torch.empty((b, n), dtype=xr.dtype, device=xr.device)
    if xr.numel() == 0:  # an empty batch: nothing to launch
        return yr, yi
    mr, mi, n1 = _slab(xr, m_pad, in1)
    if fake.launch("bluestein_inv", (xr, xi, *luts), (yr, yi), (mr, mi), n=n, m_pad=m_pad):
        return yr, yi
    p = build.ptr
    rc = build.function("repro_bluestein_inv", _INV)(
        b, n, m_pad, n1, p(xr), p(xi), *map(p, luts), p(yr), p(yi), p(mr), p(mi),
        build.stream_ptr(xr),
    )
    build.check(rc, "bluestein_inv")
    COUNTS["bluestein_inv"] += 1
    return yr, yi


def _elem_widths(stage: str, n: int, m_pad: int):
    """(input width, output width, LUT width) of an elementwise stage."""
    if stage == "pre":
        return n, m_pad, n
    if stage == "mul":
        return m_pad, m_pad, m_pad
    if stage == "post":
        return m_pad, n, n
    raise PlanError(f"bluestein_elem: stage must be one of {STAGES}, got {stage!r}")


def bluestein_elem_plain(xr, xi, planes, *, stage: str, n: int, m_pad: int):
    """Plain PyTorch version of an elementwise stage (any device)."""
    COUNTS["bluestein_elem_plain"] += 1
    if stage == "post":
        xr, xi = xr[:, :n], xi[:, :n]
    yr, yi = cmul(xr, xi, *planes)
    if stage == "pre":
        yr = torch.nn.functional.pad(yr, (0, m_pad - n))
        yi = torch.nn.functional.pad(yi, (0, m_pad - n))
    return yr, yi


def bluestein_elem_call(xr, xi, planes, *, stage: str, n: int, m_pad: int):
    """One elementwise chirp stage of the split regime: ``pre`` (B, n) →
    chirp·x zero-padded to (B, M); ``mul`` (B, M) → x ⊙ B̂; ``post``
    (B, M) → post·x[:, :n] (B, n).  ``planes``: the stage's LUT pair."""
    _check_pad("bluestein_elem", n, m_pad)
    w_in, w_out, w_lut = _elem_widths(stage, n, m_pad)
    _check("bluestein_elem", xr, xi, w_in, planes, [(w_lut,)] * 2)
    if xr.device.type == "cpu" and not fake.is_fake(xr):
        return bluestein_elem_plain(xr, xi, planes, stage=stage, n=n, m_pad=m_pad)
    return _launch_elem(xr, xi, planes, w_in, w_out)


@tracing.span("kernel.bluestein_elem")
@build.on_device
def _launch_elem(xr, xi, planes, w_in, w_out):
    b = xr.shape[0]
    yr = torch.empty((b, w_out), dtype=xr.dtype, device=xr.device)
    yi = torch.empty((b, w_out), dtype=xr.dtype, device=xr.device)
    if xr.numel() == 0:  # an empty batch: nothing to launch
        return yr, yi
    if fake.launch("bluestein_elem", (xr, xi, *planes), (yr, yi)):
        return yr, yi
    p = build.ptr
    rc = build.function("repro_bluestein_elem", _ELEM)(
        b, w_in, w_out, p(xr), p(xi), *map(p, planes), p(yr), p(yi), build.stream_ptr(xr),
    )
    build.check(rc, "bluestein_elem")
    COUNTS["bluestein_elem"] += 1
    return yr, yi
