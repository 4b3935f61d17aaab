"""The pass-program executor: walks :attr:`FFTPlan.passes`, one kernel per pass.

Port of ``repro/kernels/ops.py``.  Every program pass is exactly one kernel
call (one HBM round trip):

* whole-signal pass  → :func:`~repro_torch.kernels.dft_matmul.dft_matmul_call`
  or :func:`~repro_torch.kernels.fft4step.fft4step_call`;
* strided-column pass → :func:`~repro_torch.kernels.pencil.cols_pass_call`,
  with the inter-factor twiddle in its epilogue;
* contiguous-row pass with the natural-order transpose fused into its write
  → :func:`~repro_torch.kernels.pencil.rows_natural_call`;
* Bluestein pass (any-length transform) →
  :func:`~repro_torch.kernels.bluestein.bluestein_fwd_call` /
  :func:`~repro_torch.kernels.bluestein.bluestein_inv_call` in the fused
  regime, :func:`~repro_torch.kernels.bluestein.bluestein_elem_call` for the
  chirp stages of the split regime, whose conv is the pad length's own
  program with each pass's direction pinned (:attr:`Pass.inverse`);
* column pass of a 2-D program (``axis=-2``, :func:`execute_program2d`) →
  :func:`~repro_torch.kernels.pencil.cols_pass_call` in place over the
  image's width (fused-regime columns, or the strided factor of strip-mined
  columns with its twiddle broadcast over the width), or
  :func:`~repro_torch.kernels.pencil.cols_natural_call` for the last factor
  of strip-mined columns, which writes the n2 axis in natural order.

A tuned plan's ``forms`` (pass index → form, :func:`check_forms`) pick the
column and row passes' on-chip tile or slab on the card.

Between passes there are views only (``Tensor.view``) — no transpose, copy
or twiddle multiply of its own.  The one exception is the reference's: a
multi-pass plan run down ``axis=-2`` of a 1-D spec goes through a transpose
sandwich.  On CUDA tensors each pass launches its kernel; on CPU tensors
each kernel wrapper takes its plain version, so a CPU run walks the same
program one plain call per pass.

LUTs are device-resident: the float64 host tables of ``core/twiddle.py``
are uploaded once per (device, sizes, direction) and kept.  Every kernel
of a power-of-two pass (``dft_matmul``, ``fft4step``, ``cols_pass``,
``rows_natural``, ``cols_natural``) is a radix FFT: it reads one table of
f-th roots of its transform length (:func:`_roots_luts`, 8f bytes) and
applies the inverse's 1/f at its store, so the factors of a program
multiply to 1/n.  A fused Bluestein pass carries the chirp tables of the
outer direction and the pad length's roots table of its own stage
(forward for ``fwd``, inverse for ``inv``, whose kernel applies 1/M at
its store).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import fake, faults
from repro_torch.core import plan as plan_lib
from repro_torch.core import twiddle as tw
from repro_torch.kernels import bluestein, dft_matmul, fft4step, pencil

Planes = Tuple[torch.Tensor, torch.Tensor]

__all__ = [
    "device_key",
    "plan_luts",
    "recomb_luts",
    "pass_kernel",
    "plan_kernels",
    "form_passes",
    "check_forms",
    "execute_program",
    "execute_program2d",
    "execute_plan",
]


def device_key(device) -> str:
    """Canonical device string of a LUT cache key (``cuda`` → ``cuda:<i>``)."""
    device = torch.device(device)
    if fake.active():
        return str(fake.card())
    if device.type == "cuda" and device.index is None:
        return f"cuda:{torch.cuda.current_device()}"
    return str(device)


def _upload(planes, device: str) -> tuple:
    if fake.active():  # the simulated card: the shapes, no values to upload
        return tuple(torch.empty(np.shape(a), dtype=torch.float32, device=device) for a in planes)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in planes)


@fake.device_cache(maxsize=64)
def _roots_luts(device: str, n: int, inverse: bool) -> tuple:
    """The (n,) roots table of a radix pass (no 1/n folded)."""
    return _upload(tw.roots(n, inverse), device)


@fake.device_cache(maxsize=16)
def _pass_twiddle_luts(device: str, n_bins: int, n_phases: int, inverse: bool) -> tuple:
    """The (n_bins, n_phases) inter-factor grid of a column pass."""
    return _upload(tw.pass_twiddle(n_bins, n_phases, inverse), device)


@fake.device_cache(maxsize=64)
def recomb_luts(device: str, n: int, inverse: bool) -> tuple:
    """The (n//2 + 1,) phasor LUT of the real-FFT recombination:
    e^{∓2πik/n}, conjugated for the inverse."""
    return _upload(tw.rfft_recomb_twiddle(n, inverse=inverse), device)


@fake.device_cache(maxsize=64)
def _chirp_luts(device: str, n: int, inverse: bool) -> tuple:
    return _upload(tw.bluestein_chirp(n, inverse), device)


@fake.device_cache(maxsize=64)
def _spectrum_luts(device: str, n: int, m_pad: int, inverse: bool) -> tuple:
    return _upload(tw.bluestein_spectrum(n, m_pad, inverse), device)


@fake.device_cache(maxsize=64)
def _postchirp_luts(device: str, n: int, inverse: bool) -> tuple:
    return _upload(tw.bluestein_postchirp(n, inverse), device)


def _bluestein_luts(device: str, p: plan_lib.Pass, inverse: bool) -> tuple:
    """The LUT planes of one Bluestein pass stage, interned piecewise per
    (device, n, M, direction): the (n,) chirp, the (M,) chirp spectrum B̂,
    the (n,) post-chirp (1/n folded in for an outer inverse) and, for the
    fused stages, the (M,) roots table of the inner transform: ``fwd``
    reads (chirp, forward roots, B̂), ``inv`` (inverse roots, post-chirp).
    The inner conv is always forward then inverse; ``inverse`` only picks
    the chirp tables (reference ``src/repro/kernels/ops.py:99``)."""
    n, m_pad = p.n, p.n1
    if p.stage == "pre":
        return _chirp_luts(device, n, inverse)
    if p.stage == "mul":
        return _spectrum_luts(device, n, m_pad, inverse)
    if p.stage == "post":
        return _postchirp_luts(device, n, inverse)
    if p.stage == "fwd":
        return (*_chirp_luts(device, n, inverse), *_roots_luts(device, m_pad, False),
                *_spectrum_luts(device, n, m_pad, inverse))
    if p.stage == "inv":
        return (*_roots_luts(device, m_pad, True), *_postchirp_luts(device, n, inverse))
    raise faults.PlanError(f"unknown bluestein stage {p.stage!r}")


def _pass_inverse(p: plan_lib.Pass, inverse: bool) -> bool:
    """The direction a pass runs: its own where it pins one (the passes of
    a split-regime Bluestein conv), else the program's."""
    return p.inverse if p.inverse is not None else inverse


def _check_supported(p: plan_lib.Pass) -> None:
    if p.kind == "reorder":
        raise NotImplementedError(
            "the digit-reversal reorder pass (n > 2^32) is not ported yet: "
            "ROADMAP A, pass-program executor"
        )
    pencils, stride, _f = p.view_in
    if pencils > 1 and stride == 1 and p.view_out == p.view_in:
        raise NotImplementedError(
            "pencil-order row passes (order='pencil' programs) are not ported yet: "
            "ROADMAP A, pass-program executor"
        )


def pass_kernel(p: plan_lib.Pass) -> str:
    """Name of the kernel (and ``COUNTS`` key) that executes pass ``p``."""
    _check_supported(p)
    if p.kind == "bluestein":
        return "bluestein_elem" if p.stage in bluestein.STAGES else f"bluestein_{p.stage}"
    pencils, stride, _f = p.view_in
    if p.axis == -2:
        # Whole columns and strided column factors transform in place; the
        # last factor of strip-mined columns writes the n2 axis in order.
        return "cols_natural" if pencils > 1 and stride == 1 else "cols_pass"
    if pencils == 1:
        return "dft_matmul" if p.kind == "direct" else "fft4step"
    return "rows_natural" if stride == 1 else "cols_pass"


def plan_kernels(fft_plan: plan_lib.FFTPlan, axis: int = -1) -> tuple:
    """The kernel each pass of ``fft_plan`` launches, in order, when it runs
    over ``axis`` (-2: a 1-D plan down the second-to-last axis)."""
    if axis == -2 and fft_plan.n2 is None and len(fft_plan.passes) == 1:
        return ("cols_pass",)  # one in-place whole-column pass
    return tuple(pass_kernel(p) for p in fft_plan.passes)


def form_passes(fft_plan: plan_lib.FFTPlan, axis: int = -1) -> dict:
    """``{pass index: (kernel, f)}`` of the passes that take a form (the
    column and row passes, :data:`~repro_torch.kernels.pencil.FORMS`) when
    ``fft_plan`` runs over ``axis``; a one-pass plan down axis -2 is one
    whole-column pass of length n."""
    kernels = plan_kernels(fft_plan, axis)
    out = {}
    for i, (p, kernel) in enumerate(zip(fft_plan.passes, kernels)):
        if kernel in ("cols_pass", "rows_natural", "cols_natural"):
            out[i] = (kernel, p.view_in[2] if p.view_in else p.n)
    return out


def check_forms(fft_plan: plan_lib.FFTPlan, forms: dict, axis: int = -1, budget=None) -> None:
    """Raise :class:`~repro_torch.core.faults.PlanError` unless every entry of
    ``forms`` (pass index → form) names a column or row pass of the program,
    fits its length, and takes no more shared memory than ``budget`` bytes
    (None: no limit)."""
    takes = form_passes(fft_plan, axis)
    for i, form in forms.items():
        if i not in takes:
            raise faults.PlanError(f"pass {i} takes no form: the forms are for passes {sorted(takes)}")
        kernel, f = takes[i]
        if not pencil.form_fits(f, form):
            raise faults.PlanError(f"pass {i} ({kernel}, f={f}): form {form} does not fit; "
                                   f"one of {pencil.FORMS} with room for f")
        if budget is not None and pencil.form_smem_bytes(form) > budget:
            raise faults.PlanError(
                f"pass {i} ({kernel}, f={f}): form {form} takes {pencil.form_smem_bytes(form)} B "
                f"of shared memory, the block may take {budget} B"
            )


def plan_luts(fft_plan: plan_lib.FFTPlan, inverse: bool, device, axis: int = -1) -> tuple:
    """Upload (or find) every LUT the plan's passes read on ``device`` when
    it runs over ``axis``: the roots table of a power-of-two pass, the chirp
    tables and the pad's roots table of a Bluestein pass, and each pass's
    inter-factor twiddle.  Raises NotImplementedError for a pass the port
    does not run yet."""
    dev = device_key(device)
    plan_kernels(fft_plan, axis)  # raises for a pass the port does not run yet
    luts = []
    for p in fft_plan.passes:
        eff = _pass_inverse(p, inverse)
        if p.kind == "bluestein":
            luts.extend(_bluestein_luts(dev, p, eff))
            continue
        luts.extend(_roots_luts(dev, p.n, eff))
        if p.twiddle_after is not None:
            luts.extend(_pass_twiddle_luts(dev, *p.twiddle_after, eff))
    return tuple(luts)


def _bluestein_pass(xr, xi, p: plan_lib.Pass, inverse: bool) -> Planes:
    """One Bluestein stage over (B, width) planes: one kernel call."""
    luts = _bluestein_luts(device_key(xr.device), p, inverse)
    kw = dict(n=p.n, m_pad=p.n1)
    if p.stage in bluestein.STAGES:
        return bluestein.bluestein_elem_call(xr, xi, luts, stage=p.stage, **kw)
    call = bluestein.bluestein_fwd_call if p.stage == "fwd" else bluestein.bluestein_inv_call
    # The planner's split of the pad: the four-step of the slab form.
    return call(xr, xi, luts, in1=plan_lib._leaf_pass(p.n1).n1, **kw)


def _apply_pass(xr, xi, p: plan_lib.Pass, inverse: bool, form=None) -> Planes:
    """One row-axis program pass over (B, width) split planes: exactly one
    kernel call.  A pass that pins its direction (:attr:`Pass.inverse`, the
    inner conv of a split-regime Bluestein program) runs in it; ``form`` is
    a column or row pass's tuned form (None: the table's)."""
    kernel = pass_kernel(p)
    faults.maybe_fail("kernel.launch", backend=xr.device.type, pass_kind=p.kind)
    inverse = _pass_inverse(p, inverse)
    if p.kind == "bluestein":
        return _bluestein_pass(xr, xi, p, inverse)
    dev = device_key(xr.device)
    b, n = xr.shape
    pencils, stride, f = p.view_in
    if kernel == "dft_matmul":
        return dft_matmul.dft_matmul_call(xr, xi, *_roots_luts(dev, n, inverse), inverse=inverse)
    if kernel == "fft4step":
        return fft4step.fft4step_call(
            xr, xi, *_roots_luts(dev, n, inverse), n1=p.n1, inverse=inverse,
            natural_order=p.order == "natural",
        )
    roots = _roots_luts(dev, f, inverse)
    if kernel == "rows_natural":
        # (b, p, f) → (b, f, p) flattens to natural order.
        yr, yi = pencil.rows_natural_call(
            xr.view(b, pencils, f), xi.view(b, pencils, f), *roots, n1=p.n1, inverse=inverse,
            tile=form,
        )
        return yr.view(b, n), yi.view(b, n)
    groups = pencils // stride
    twiddle = None
    if p.twiddle_after is not None:
        twiddle = _pass_twiddle_luts(dev, *p.twiddle_after, inverse)
    yr, yi = pencil.cols_pass_call(
        xr.view(b * groups, f, stride), xi.view(b * groups, f, stride), *roots, twiddle,
        n1=p.n1, inverse=inverse, tile=form,
    )
    return yr.view(b, n), yi.view(b, n)


def _cols_image_pass(xr, xi, p: plan_lib.Pass, inverse: bool, form=None) -> Planes:
    """Column pass of a 2-D program: transform axis -2 of the (B, rows, w)
    image through the column kernels, over the whole width at once (any
    width: the kernel handles a ragged last chunk, so the reference's pad
    copy is not needed).

    Whole columns (``view_in == (1, 1, rows)``, or a 1-D plan's synthetic
    pass from :func:`_cols_plan_pass`) are one in-place column pass.
    Strip-mined columns arrive as the re-tagged 1-D program of the n2 axis:
    the strided factor runs in place on the (B, f, stride·w) view with its
    (f, stride) twiddle broadcast over runs of w columns, and the last
    factor writes (B, P, f, w) as (B, f, P, w), the n2 axis in natural
    order.  ``form`` as :func:`_apply_pass`'s."""
    kernel = pass_kernel(p)
    faults.maybe_fail("kernel.launch", backend=xr.device.type, pass_kind=p.kind)
    dev = device_key(xr.device)
    b, rows, w = xr.shape
    pencils, stride, f = p.view_in
    if pencils == 1 or f == rows:
        return pencil.cols_pass_call(xr, xi, *_roots_luts(dev, f, inverse), n1=p.n1,
                                     inverse=inverse, tile=form)
    if kernel == "cols_pass":
        # Strided column factor (strip-mined columns have two factors):
        # n2-index t·stride + r, transform over t; the twiddle phase depends
        # on r only, shared by the w columns.
        twiddle = None
        if p.twiddle_after is not None:
            twiddle = _pass_twiddle_luts(dev, *p.twiddle_after, inverse)
        yr, yi = pencil.cols_pass_call(
            xr.view(b, f, stride * w), xi.view(b, f, stride * w), *_roots_luts(dev, f, inverse),
            twiddle, n1=p.n1, inverse=inverse, tw_every=w, tile=form,
        )
    else:
        yr, yi = pencil.cols_natural_call(
            xr.view(b, pencils, f, w), xi.view(b, pencils, f, w), *_roots_luts(dev, f, inverse),
            n1=p.n1, inverse=inverse, tile=form,
        )
    return yr.view(b, rows, w), yi.view(b, rows, w)


def execute_program(xr, xi, passes: Sequence[plan_lib.Pass], *, inverse: bool = False,
                    forms=None) -> Planes:
    """Walk a linearized pass program over 2-D (B, n) split planes;
    ``forms`` maps a pass index to its form (see :func:`form_passes`)."""
    forms = forms or {}
    for i, p in enumerate(passes):
        xr, xi = _apply_pass(xr, xi, p, inverse, forms.get(i))
    return xr, xi


def execute_program2d(xr, xi, passes: Sequence[plan_lib.Pass], *, inverse: bool = False,
                      forms=None) -> Planes:
    """Walk a mixed-axis pass program over 3-D (B, n2, n) image planes.

    ``axis=-1`` passes run the 1-D machinery over the (B·n2, width) row
    view; ``axis=-2`` passes transform the image's columns in place through
    :func:`_cols_image_pass`.  The row → column handoff is a view: a planned
    ``fft2`` is exactly its rows' and columns' kernel calls.  The row width
    is read from each pass's output: a Bluestein row program changes it
    mid-program (n → M → n).  ``forms`` as :func:`execute_program`'s."""
    forms = forms or {}
    for i, p in enumerate(passes):
        b, rows, n = xr.shape
        if p.axis == -2:
            xr, xi = _cols_image_pass(xr, xi, p, inverse, forms.get(i))
            continue
        yr, yi = _apply_pass(xr.view(b * rows, n), xi.view(b * rows, n), p, inverse, forms.get(i))
        w = yr.shape[-1]
        xr, xi = yr.view(b, rows, w), yi.view(b, rows, w)
    return xr, xi


def _cols_plan_pass(fft_plan: plan_lib.FFTPlan, stride: int) -> plan_lib.Pass:
    """A synthetic column pass running a whole one-pass plan down the -2 axis
    of an (..., n, stride) view, in place: no transpose."""
    leaf = fft_plan.passes[0]
    return plan_lib.Pass(
        kind=leaf.kind,
        n=fft_plan.n,
        n1=leaf.n1,
        n2=leaf.n2,
        view_in=(stride, stride, fft_plan.n),
        view_out=(stride, stride, fft_plan.n),
        order="natural",
        axis=-2,
    )


def _lead(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def execute_plan(xr, xi, fft_plan: plan_lib.FFTPlan, *, inverse: bool = False, axis: int = -1,
                 forms=None) -> Planes:
    """Execute ``fft_plan`` over ``axis`` (-1 or -2) of split float32 planes
    with any leading batch dims.

    A multi-axis plan (``fft_plan.n2`` set) takes (..., n2, n) images and
    walks its joint program with :func:`execute_program2d`.  ``axis=-2``
    runs a one-pass plan as one in-place column pass and a longer plan
    through the reference's transpose sandwich.  ``forms`` (pass index →
    form, :func:`check_forms`) picks the column and row passes' forms on
    the card; the plain versions have none, so the CPU route ignores it."""
    # The planes go to the first pass as contiguous temporaries (no name
    # here keeps them alive past it).
    if xi.shape != xr.shape:
        raise faults.PlanError(f"real plane {tuple(xr.shape)} and imaginary {tuple(xi.shape)} differ")
    if fft_plan.n2 is not None:
        if axis != -1:
            raise faults.PlanError("multi-axis plans always transform the last two axes")
        rows, n = xr.shape[-2:]
        if (rows, n) != (fft_plan.n2, fft_plan.n):
            raise faults.PlanError(
                f"plan is for ({fft_plan.n2}, {fft_plan.n}) images, got ({rows}, {n})"
            )
        lead = xr.shape[:-2]
        b = _lead(lead)
        yr, yi = execute_program2d(
            xr.contiguous().view(b, rows, n), xi.contiguous().view(b, rows, n),
            fft_plan.passes, inverse=inverse, forms=forms,
        )
        return yr.view(*lead, rows, n), yi.view(*lead, rows, n)
    if axis == -2:
        n, q = xr.shape[-2:]
        if n != fft_plan.n:
            raise faults.PlanError(f"plan is for n={fft_plan.n}, axis -2 has n={n}")
        lead = xr.shape[:-2]
        if len(fft_plan.passes) == 1:
            b = _lead(lead)
            yr, yi = _cols_image_pass(
                xr.contiguous().view(b, n, q), xi.contiguous().view(b, n, q),
                _cols_plan_pass(fft_plan, q), inverse, (forms or {}).get(0),
            )
            return yr.view(*lead, n, q), yi.view(*lead, n, q)
        yr, yi = execute_plan(xr.transpose(-1, -2), xi.transpose(-1, -2), fft_plan, inverse=inverse,
                              forms=forms)
        return yr.transpose(-1, -2).contiguous(), yi.transpose(-1, -2).contiguous()
    if axis != -1:
        raise faults.PlanError(f"execute_plan handles axis -1 or -2, got {axis}")
    n = xr.shape[-1]
    if n != fft_plan.n:
        raise faults.PlanError(f"plan is for n={fft_plan.n}, input has n={n}")
    lead = xr.shape[:-1]
    b = _lead(lead)
    yr, yi = execute_program(
        xr.contiguous().view(b, n), xi.contiguous().view(b, n), fft_plan.passes, inverse=inverse,
        forms=forms,
    )
    return yr.view(*lead, n), yi.view(*lead, n)
