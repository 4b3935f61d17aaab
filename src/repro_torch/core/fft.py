"""Public FFT API — plan-and-execute over a backend registry.

Port of ``repro/core/fft.py``::

    spec    = FFTSpec(n=4096, kind="fft")
    planned = plan(spec)             # interned: plan(spec) is plan(spec)
    y       = planned(x)             # runs the frozen pass program

:func:`plan` resolves an :class:`FFTSpec` into a hashable
:class:`PlannedFFT` carrying the :class:`~repro_torch.core.plan.FFTPlan`
(the reference's pass program, pass for pass), its device-resident LUTs and
a backend from the registry:

``cuda``   the hand-written CUDA kernels (``repro_torch.kernels``), one
           launch per pass;
``torch``  the same pass program through each kernel's plain PyTorch
           version, on the CPU.

The kinds:

* ``fft`` / ``ifft`` — one plan over ``axis`` (``-1``; ``-2`` runs a one-pass
  plan as one in-place column pass; any other axis moves to the last);
* ``fft2`` / ``ifft2`` — ONE joint program over the last two axes: row
  passes, then the column passes in place (strip-mined for n2 > 65536;
  past ``FUSED_MAX²`` the row plan and an ``axis=-2`` column plan,
  composed, as the reference does);
  :meth:`PlannedFFT.apply_rows` / :meth:`PlannedFFT.apply_cols` run either
  half alone (the distributed ``pfft2d`` runs them around its all-to-all);
* ``rfft`` / ``irfft`` — the half-length complex child plan of the even/odd
  packing plus the Hermitian recombination pass (its ``epilogue``); an odd
  length runs one full-length complex child instead, with no epilogue;
* ``rfft2`` / ``irfft2`` — packed rows, the recombination row-wise, and an
  ``axis=-2`` complex child over the (…, n2, n/2 + 1) half-spectrum.

Any length runs: a non-power-of-two transform (the rows of ``fft2``, the
complex or packed child of the real kinds) is the planner's Bluestein
chirp convolution at a power-of-two pad M ≥ 2n − 1, as in the reference;
``rfft2``/``irfft2`` and every column length ``n2`` stay powers of two.

``plan(spec)`` runs on the card.  Without a card it raises: it never picks
the CPU on its own.  ``plan(spec, device="cpu")`` asks for the plain route.
The reference's scope API names a backend (:func:`get_backend`,
:func:`use_backend`, :func:`default_backend`, the deprecated
:func:`set_default_backend`, ``REPRO_FFT_BACKEND``, ``backend=`` on
:func:`plan` and the wrappers), but the device still decides: a backend
named for another device raises :class:`PlanError`.  Nothing falls back
from a kernel to its plain version or from the card to the CPU.

Complex kinds take complex tensors or split ``(real, imag)`` float32 planes
and return whichever form was supplied; ``rfft``/``rfft2`` take a real
signal and return planes, ``irfft``/``irfft2`` take planes (or a complex
tensor) and return the real signal, as the reference does.  A transform
past ``FUSED_MAX²`` = 2³² points plans as the reference's program of three
or more factors with its reorder pass; only a Bluestein pad past
``fused_max²`` raises ``NotImplementedError``, in the reference's words.

``plan(spec, tune=)`` takes the reference's modes (:mod:`repro_torch.core.tuning`):
``None`` resolves to ``REPRO_FFT_TUNE``, else ``"model"``.  On the card the
program comes from the tuner's config (``fused_max``, ``direct_max``,
``bluestein_pad`` and the column and row passes' ``forms``); the CPU route
runs the heuristic program whatever the mode, as the reference's ``xla``
backend does.

``planned(x, check="nan" | "parseval")`` arms the reference's opt-in
numerics guards over the result, and :func:`plan_log` records every plan
created, as the reference's does.

Every kind differentiates, on both routes, through two autograd leaves: the
complex pass program (:class:`_PassProgram`, planes in, planes out) and the
Hermitian recombination pass (:class:`_Recomb`).  Each is a linear map that
needs only its plan, so neither saves a tensor, and each backward runs the
same kernels in the other direction: a DFT's adjoint is the opposite
direction's unnormalised transform, the recombination's adjoint the other
recombination kernel with the end bins fixed up.  Everything between the
leaves (planes ↔ complex, packing, interleaving, slicing, ``movedim``) is
plain differentiable torch.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import threading
import warnings
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import fake
from repro_torch.core import plan as plan_lib
from repro_torch.core.faults import NumericsError, PlanError
from repro_torch.core.fft_torch import contiguous, copied
from repro_torch.runtime import tracing

Planes = Tuple[torch.Tensor, torch.Tensor]
ArrayOrPlanes = Union[torch.Tensor, Planes]

__all__ = [
    "FFTSpec",
    "PlannedFFT",
    "Backend",
    "plan",
    "register_backend",
    "available_backends",
    "get_backend",
    "use_backend",
    "default_backend",
    "set_default_backend",
    "fft",
    "ifft",
    "rfft",
    "irfft",
    "fft2",
    "ifft2",
    "rfft2",
    "irfft2",
    "PARSEVAL_RTOL",
    "plan_log",
    "clear_plan_log",
]

KINDS = ("fft", "ifft", "rfft", "irfft", "fft2", "ifft2", "rfft2", "irfft2")
_COMPLEX_KINDS = ("fft", "ifft")
_2D_KINDS = ("fft2", "ifft2", "rfft2", "irfft2")

#: Relative tolerance of the ``check="parseval"`` energy guard.
PARSEVAL_RTOL = 1e-2

_CHECKS = ("nan", "parseval")


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class FFTSpec:
    """What to transform — the hashable key a :class:`PlannedFFT` is built for.

    Same fields and validation as the reference's ``FFTSpec``: ``n`` (length
    along ``axis``), ``kind``, ``axis``, ``precision``, ``batch_hint`` and
    ``n2`` (2-D kinds).  Which specs this slice executes is decided by
    :func:`plan`.
    """

    n: int
    kind: str = "fft"
    axis: int = -1
    precision: str = "float32"
    batch_hint: Optional[int] = None
    n2: Optional[int] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise PlanError(f"unknown FFT kind {self.kind!r}; one of {KINDS}")
        if self.n < 1:
            raise PlanError(f"FFT length must be >= 1, got {self.n}")
        if self.kind in ("rfft2", "irfft2") and not _is_pow2(self.n):
            raise PlanError(
                f"{self.kind} requires a power-of-two row length, got n={self.n}; "
                f"non-power-of-two lengths are supported for "
                f"{_COMPLEX_KINDS + ('rfft', 'irfft', 'fft2', 'ifft2')} via the "
                f"Bluestein chirp-conv route"
            )
        if self.kind in ("rfft", "irfft", "rfft2", "irfft2") and self.n < 2:
            raise PlanError(f"{self.kind} length must be >= 2, got {self.n}")
        if self.kind in _2D_KINDS:
            if self.n2 is None or not _is_pow2(self.n2):
                raise PlanError(
                    f"{self.kind} needs a power-of-two n2 (column length), got "
                    f"{self.n2}; only the last (row) axis takes non-power-of-two "
                    f"lengths (Bluestein route)"
                )
            if self.axis != -1:
                raise PlanError(f"{self.kind} always transforms the last two axes")
        elif self.n2 is not None:
            raise PlanError(f"n2 is only meaningful for the 2-D kinds {_2D_KINDS}")
        if self.batch_hint is not None and self.batch_hint < 1:
            raise PlanError(f"batch_hint must be >= 1, got {self.batch_hint}")


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Backend:
    """A registered executor of a plan's pass program.

    ``fn(xr, xi, *, inverse, planned, axis)`` runs ``planned.fft_plan`` over
    ``axis`` (-1, or -2 for a 1-D plan down the columns) of split float32
    planes on ``planned.device``; ``device_types`` are the torch device
    types it runs on.
    """

    name: str
    fn: Callable
    device_types: frozenset


_REGISTRY: dict = {}


def register_backend(name: str, fn: Callable, device_types) -> Backend:
    """Register ``fn`` as backend ``name`` for ``device_types``."""
    if name in _REGISTRY:
        raise PlanError(f"FFT backend {name!r} is already registered")
    entry = Backend(name, fn, frozenset(device_types))
    _REGISTRY[name] = entry
    _plan_cached.cache_clear()
    return entry


def available_backends() -> tuple:
    return tuple(sorted(_REGISTRY))


def get_backend(name: str) -> Backend:
    """The registered backend ``name``; :class:`PlanError` for an unknown one."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise PlanError(f"unknown FFT backend {name!r}; registered: {available_backends()}") from None


def _backend_for(device: torch.device, name: Optional[str] = None) -> Backend:
    """Backend ``name`` (None: the first registered one that runs on
    ``device``'s type), checked against ``device``: no backend runs on a
    device it was not registered for, so naming one never moves a tensor
    or picks a plain version.  Under the dry run's fake mode the device is
    the card."""
    dtype = "cuda" if fake.active() else device.type
    if name is not None:
        entry = get_backend(name)
        if dtype not in entry.device_types:
            raise PlanError(
                f"FFT backend {name!r} runs on {sorted(entry.device_types)}, the plan's device is "
                f"{'the card' if fake.active() else device}"
            )
        return entry
    for entry in _REGISTRY.values():
        if dtype in entry.device_types:
            return entry
    raise PlanError(f"no registered FFT backend runs on {device}")


# ---------------------------------------------------------------------------
# Default-backend scoping
# ---------------------------------------------------------------------------

_GLOBAL_DEFAULT: Optional[str] = os.environ.get("REPRO_FFT_BACKEND") or None
_scope = threading.local()


def _scope_stack() -> list:
    stack = getattr(_scope, "stack", None)
    if stack is None:
        stack = _scope.stack = []
    return stack


@contextlib.contextmanager
def use_backend(name: str):
    """Scope the default FFT backend: ``with use_backend("torch"): ...``.

    Nested scopes stack; the previous default comes back on exit, also when
    the body raises.  The name is checked against the registry on entry; a
    plan made inside the scope on a device the backend does not run on
    raises :class:`PlanError`."""
    get_backend(name)
    stack = _scope_stack()
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()


def default_backend() -> Optional[str]:
    """The backend name new plans take absent a per-call ``backend=``: the
    innermost :func:`use_backend` scope, else ``REPRO_FFT_BACKEND``, else
    None (the plan's device picks: ``cuda`` on the card, ``torch`` on the
    CPU)."""
    stack = _scope_stack()
    return stack[-1] if stack else _GLOBAL_DEFAULT


def set_default_backend(name: str) -> None:
    """Deprecated: use :func:`use_backend` (scoped) or ``backend=``."""
    warnings.warn(
        "set_default_backend is deprecated; use the use_backend() context manager (scoped) "
        "or pass backend= to plan()",
        DeprecationWarning,
        stacklevel=2,
    )
    global _GLOBAL_DEFAULT
    get_backend(name)
    _GLOBAL_DEFAULT = name


# ---------------------------------------------------------------------------
# Planes helpers
# ---------------------------------------------------------------------------


def _float32(a: torch.Tensor) -> torch.Tensor:
    """``a`` as float32, the copy counted where one is made."""
    return a if a.dtype == torch.float32 else copied(a.to(torch.float32))


def _plane(a, device: torch.device) -> torch.Tensor:
    if torch.is_tensor(a):
        if a.device != device:
            raise PlanError(f"input is on {a.device}, the plan runs on {device}")
        return _float32(a)
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


def _split(x: ArrayOrPlanes, device: torch.device) -> tuple:
    """(real, imag, was_complex) float32 planes on ``device``."""
    if isinstance(x, (tuple, list)):
        xr, xi = x
        return _plane(xr, device), _plane(xi, device), False
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x), device=device)
    if x.device != device:
        raise PlanError(f"input is on {x.device}, the plan runs on {device}")
    if x.is_complex():
        return _float32(x.real), _float32(x.imag), True
    xr = _float32(x)
    return xr, torch.zeros_like(xr), True


def _join(yr, yi, was_complex: bool) -> ArrayOrPlanes:
    return copied(torch.complex(yr, yi)) if was_complex else (yr, yi)


def _real(x, device: torch.device, kind: str) -> torch.Tensor:
    """A real signal as a float32 tensor on ``device``."""
    if isinstance(x, (tuple, list)) or (torch.is_tensor(x) and x.is_complex()):
        raise PlanError(f"{kind} transforms a real signal; got a complex input")
    return _plane(x, device)


# ---------------------------------------------------------------------------
# PlannedFFT
# ---------------------------------------------------------------------------


class PlannedFFT:
    """A frozen, executable transform schedule on one device.

    Carries the :class:`FFTSpec`, the :class:`Backend`, the
    :class:`~repro_torch.core.plan.FFTPlan`, the device-resident LUTs of its
    passes and the tuner's config it was built from (``tuned``; None: the
    fixed heuristics) with the column and row passes' ``forms``.  The
    real-packing kinds carry no plan of their own: they hold child handles for their complex transforms and an ``epilogue``
    :class:`~repro_torch.core.plan.Pass` — the Hermitian recombination, one
    kernel launch — with its phasor LUT in ``luts``.  Calling it runs the
    transform; instances are interned by :func:`plan`, so
    ``plan(spec) is plan(spec)``.
    """

    def __init__(self, spec: FFTSpec, backend: Backend, fft_plan: Optional[plan_lib.FFTPlan],
                 device: torch.device, luts: tuple = (), *, children: tuple = (),
                 epilogue: Optional[plan_lib.Pass] = None, tuned: Optional[dict] = None):
        self.spec = spec
        self.backend = backend
        self.fft_plan = fft_plan
        self.device = device
        self.luts = luts
        self.children = children
        self.epilogue = epilogue
        #: The tuning config this plan was built from (None: the heuristics).
        self.tuned = tuned
        #: Pass index → form of its column or row pass (empty: the table's).
        self.forms = {int(k): int(v) for k, v in (tuned or {}).get("forms", {}).items()}

    def _key(self) -> tuple:
        tuned = json.dumps(self.tuned, sort_keys=True) if self.tuned else None
        return (self.spec, self.backend.name, str(self.device), tuned)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, PlannedFFT) and self._key() == other._key()

    def __repr__(self):
        return f"PlannedFFT({self.spec}, backend={self.backend.name!r}, device={str(self.device)!r})"

    # -- introspection -----------------------------------------------------

    def _stages(self) -> tuple:
        """Children and the epilogue pass in the order they run."""
        ep = (self.epilogue,) if self.epilogue is not None else ()
        kind = self.spec.kind
        if kind == "irfft":
            return ep + self.children
        if kind == "rfft2":
            inner, cols = self.children
            return (inner,) + ep + (cols,)
        if kind == "irfft2":
            inner, cols = self.children
            return (cols,) + ep + (inner,)
        return self.children + ep

    @property
    def passes(self) -> tuple:
        """The linearized pass program, in execution order (the children's
        passes for the real-packing kinds, with the recombination epilogue
        slotted where it runs)."""
        if self.fft_plan is not None:
            return self.fft_plan.passes
        return tuple(
            p for st in self._stages()
            for p in (st.passes if isinstance(st, PlannedFFT) else (st,))
        )

    @property
    def hbm_round_trips(self) -> int:
        if self.fft_plan is not None:
            return self.fft_plan.hbm_round_trips
        trips = sum(c.hbm_round_trips for c in self.children)
        return trips + (1 if self.epilogue is not None else 0)

    @property
    def kernels(self) -> tuple:
        """The kernel each pass launches (its ``COUNTS`` key), in order."""
        from repro_torch.kernels import ops

        if self.fft_plan is not None:
            return ops.plan_kernels(self.fft_plan, axis=-2 if self.spec.axis == -2 else -1)
        return tuple(
            k for st in self._stages()
            for k in (st.kernels if isinstance(st, PlannedFFT) else (st.kind,))
        )

    def describe(self) -> str:
        spec = self.spec
        size = f"N={spec.n2}x{spec.n}" if spec.n2 is not None else f"N={spec.n}"
        head = f"{spec.kind} {size} backend={self.backend.name} device={self.device}: "
        calls = "; kernels: " + ", ".join(f"pass {i} {k}" for i, k in enumerate(self.kernels))
        if self.fft_plan is not None:
            return (head + plan_lib.describe_program(self.fft_plan) + self._describe_tuned()
                    + self._describe_bluestein() + calls)
        text = head + " | ".join(plan_lib.describe_program(c.fft_plan) for c in self.children)
        if self.epilogue is not None:
            text += f"; epilogue pass: {self.epilogue.kind} n={self.epilogue.n}"
        return text + self._describe_bluestein() + calls

    def _describe_bluestein(self) -> str:
        """The chirp convolution of a plan that runs a Bluestein program: its
        length, pad and pad ratio, and the reference's modelled tax against
        a mixed-radix transform (:func:`~repro_torch.analysis.roofline.bluestein_report`)."""
        from repro_torch.analysis import roofline as rl  # lazy: analysis plans through here

        for p in self.passes:
            if p.kind == "bluestein":
                rep = rl.bluestein_report(p.n, pad=p.n1)
                return (
                    f"; bluestein: n={p.n} pad {rep['pad']} ({rep['pad_ratio']:.2f}x), "
                    f"{rep['flops_overhead']:.1f}x flops vs mixed-radix, "
                    f"{rep['hbm_round_trips']} hbm round trips"
                )
        return ""

    def _describe_tuned(self) -> str:
        """The tuned choices, beside the schedule they shape."""
        if not self.tuned:
            return ""
        parts = [
            f"fused_max={self.tuned['fused_max']}",
            f"direct_max={self.tuned.get('direct_max', plan_lib.DIRECT_MAX)}",
        ]
        if "bluestein_pad" in self.tuned:
            parts.append(f"bluestein_pad={self.tuned['bluestein_pad']}")
        parts += [f"pass {i} form={'slab' if f == 0 else f'2^{f}'}" for i, f in sorted(self.forms.items())]
        return "; tuned: " + ", ".join(parts)

    # -- execution ---------------------------------------------------------

    def _run(self, xr, xi, inverse: bool, axis: int = -1) -> Planes:
        """The complex pass program over ``axis``; an autograd leaf when an
        input needs a gradient."""
        if torch.is_grad_enabled() and (xr.requires_grad or xi.requires_grad):
            return _PassProgram.apply(xr, xi, self, inverse, axis)
        return self.backend.fn(xr, xi, inverse=inverse, planned=self, axis=axis)

    def _check_image(self, xr) -> None:
        n, n2 = self.spec.n, self.spec.n2
        if xr.ndim < 2 or tuple(xr.shape[-2:]) != (n2, n):
            raise PlanError(
                f"{self.spec.kind} planned for (..., {n2}, {n}) images, got shape {tuple(xr.shape)}"
            )

    def _last_axis(self, ndim: int) -> int | None:
        """The axis to move to the last place, or None when it is there."""
        ax = self.spec.axis + ndim if self.spec.axis < 0 else self.spec.axis
        if not 0 <= ax < ndim:
            raise PlanError(f"axis {self.spec.axis} out of range for a {ndim}-D input")
        return None if ax == ndim - 1 else ax

    @tracing.span("fft.apply_planes")
    def apply_planes(self, xr: torch.Tensor, xi: torch.Tensor) -> Planes:
        """Run a complex plan (``fft`` … ``ifft2``) on split float32 planes.

        ``axis=-2`` runs down the columns (one in-place column pass for a
        one-pass plan); another non-last axis is moved to the last and
        back."""
        kind = self.spec.kind
        if kind in ("fft2", "ifft2"):
            self._check_image(xr)
            if self.fft_plan is None:  # composed: the row plan, then the column plan
                rows, cols = self.children
                return cols.apply_planes(*rows.apply_planes(xr, xi))
            return self._run(xr, xi, inverse=kind == "ifft2")
        if kind not in _COMPLEX_KINDS:
            raise PlanError(f"apply_planes on {kind!r} plan; use __call__")
        inverse = kind == "ifft"
        if self.spec.axis == -2:
            if xr.ndim < 2:
                raise PlanError(f"axis=-2 needs an input of 2 or more dims, got {tuple(xr.shape)}")
            return self._run(xr, xi, inverse, axis=-2)
        ax = self._last_axis(xr.ndim)
        if ax is None:
            return self._run(xr, xi, inverse)
        yr, yi = self._run(xr.movedim(ax, -1), xi.movedim(ax, -1), inverse)
        return yr.movedim(-1, ax), yi.movedim(-1, ax)

    @property
    def pass_claims(self) -> tuple:
        """The executing backend's name once per pass of :attr:`passes`.
        The port has one backend per device and no per-pass fallback, so
        its backend claims every pass."""
        return tuple(self.backend.name for _ in self.passes)

    def _half(self, axis: int) -> tuple:
        """The passes of a 2-D program over ``axis`` (-1 the rows, -2 the
        columns) and their tuned forms re-indexed onto that half."""
        idx = [i for i, p in enumerate(self.fft_plan.passes) if p.axis == axis]
        forms = {j: self.forms[i] for j, i in enumerate(idx) if i in self.forms}
        return tuple(self.fft_plan.passes[i] for i in idx), forms

    def _check_2d(self, what: str) -> None:
        if self.spec.kind not in ("fft2", "ifft2"):
            raise PlanError(f"{what} needs a 2-D complex plan, not {self.spec.kind!r}")

    def _run_half(self, xr, xi, inverse: bool, axis: int) -> Planes:
        """One half of the 2-D program; an autograd leaf when an input needs
        a gradient."""
        if torch.is_grad_enabled() and (xr.requires_grad or xi.requires_grad):
            return _HalfProgram.apply(xr, xi, self, inverse, axis)
        return self._half_planes(xr, xi, inverse, axis)

    def _half_planes(self, xr, xi, inverse: bool, axis: int) -> Planes:
        from repro_torch.kernels import ops

        passes, forms = self._half(axis)
        if axis == -1:
            lead, n = xr.shape[:-1], xr.shape[-1]
            b = math.prod(lead)
            yr, yi = ops.execute_program(contiguous(xr).view(b, n), contiguous(xi).view(b, n), passes,
                                         inverse=inverse, forms=forms)
            return yr.view(*lead, n), yi.view(*lead, n)
        if not passes:
            return xr, xi
        lead, (rows, w) = xr.shape[:-2], xr.shape[-2:]
        b = math.prod(lead)
        yr, yi = ops.execute_program2d(contiguous(xr).view(b, rows, w), contiguous(xi).view(b, rows, w),
                                       passes, inverse=inverse, forms=forms)
        return yr.view(*lead, rows, w), yi.view(*lead, rows, w)

    def apply_rows(self, xr: torch.Tensor, xi: torch.Tensor) -> Planes:
        """Run only the row (last-axis) passes of a 2-D plan over (..., n)
        planes: the distributed pencil FFT runs the joint program in two
        halves around its all-to-all, the rows on the row-sharded slab."""
        self._check_2d("apply_rows")
        if xr.shape[-1] != self.spec.n:
            raise PlanError(f"plan is for rows of n={self.spec.n}, got {xr.shape[-1]}")
        if self.fft_plan is None:
            return self.children[0].apply_planes(xr, xi)
        return self._run_half(xr, xi, self.spec.kind == "ifft2", -1)

    def apply_cols(self, xr: torch.Tensor, xi: torch.Tensor) -> Planes:
        """Run only the column (axis -2) passes of a 2-D plan, in place over
        whatever width the (..., n2, w) slab carries (see :meth:`apply_rows`)."""
        self._check_2d("apply_cols")
        if xr.ndim < 2 or xr.shape[-2] != self.spec.n2:
            rows = xr.shape[-2] if xr.ndim >= 2 else None
            raise PlanError(f"plan is for n2={self.spec.n2} columns, got {rows}")
        if self.fft_plan is None:
            return self.children[1].apply_planes(xr, xi)
        return self._run_half(xr, xi, self.spec.kind == "ifft2", -2)

    def _recomb(self, ar, ai, kind: Optional[str] = None, luts: tuple = ()) -> Planes:
        """The epilogue pass over the last axis, row-wise over any leading
        dims: the packed (…, m) spectrum → the (…, m + 1) bins (rfft
        kinds), or back (irfft kinds); an autograd leaf when an input needs
        a gradient.  ``kind`` and ``luts`` default to the plan's epilogue (a
        backward runs the other direction's)."""
        from repro_torch.core import faults

        kind = kind or self.epilogue.kind
        faults.maybe_fail("kernel.launch", backend=ar.device.type, pass_kind=kind)
        if torch.is_grad_enabled() and (ar.requires_grad or ai.requires_grad):
            return _Recomb.apply(ar, ai, self, kind, luts)
        return self._recomb_pass(ar, ai, kind, luts or self.luts)

    @staticmethod
    def _recomb_pass(ar, ai, kind: str, luts: tuple) -> Planes:
        """One recombination pass ``kind`` with phasor ``luts``: the pencil
        wrapper launches its kernel on the card and takes the plain version
        on the CPU."""
        from repro_torch.kernels import pencil

        lead, width = ar.shape[:-1], ar.shape[-1]
        b = int(np.prod(lead)) if lead else 1
        call = pencil.rfft_recomb_call if kind == "rfft_recomb" else pencil.irfft_recomb_call
        yr, yi = call(contiguous(ar).view(b, width), contiguous(ai).view(b, width), *luts)
        return yr.view(*lead, yr.shape[-1]), yi.view(*lead, yi.shape[-1])

    def _recomb_adjoint(self, kind: str, gr, gi) -> Planes:
        """The transpose of the recombination pass ``kind``, as a
        real-linear map of the planes, by the other direction's kernel.

        The forward recombination R gives X[k] = a_k·Z[k] + b_k·conj(Z[−k])
        (indices of Z mod m, a_k = (1 − i·w_k)/2, b_k = (1 + i·w_k)/2,
        w_k = e^{−2πik/n}); the inverse one I gives Z[k] = c_k·X[k] +
        d_k·conj(X[m − k]) (c_k = (1 + i·w̄_k)/2, d_k = (1 − i·w̄_k)/2).
        Transposing them: Rᵀ(G) = I(G'), where G' is G with the real part of
        bins 0 and m doubled and their imaginary part dropped (R's bins 0
        and m are real whatever Z is); Iᵀ(G) = R(G) less (1 + i)/2·conj(G[0])
        at bin 0 and (1 + i)/2·G[0] at bin m (I reads the imaginary parts of
        X[0] and X[m], so its adjoint writes them)."""
        from repro_torch.kernels import ops

        n = self.spec.n
        forward = kind == "rfft_recomb"
        luts = ops.recomb_luts(ops.device_key(self.device), n, forward)
        if forward:
            m = gr.shape[-1] - 1
            ends = torch.zeros(m + 1, dtype=gr.dtype, device=gr.device)
            ends[0::m] = 1.0
            return self._recomb(gr * (1.0 + ends), gi * (1.0 - ends), "irfft_recomb", luts)
        m = gr.shape[-1]
        xr, xi = self._recomb(gr, gi, "rfft_recomb", luts)
        g0r, g0i = gr[..., :1], gi[..., :1]
        at = torch.arange(0, m + 1, m, device=gr.device)  # bins 0 and m, made on the device
        xr = xr.index_add(-1, at, -0.5 * torch.cat([g0r + g0i, g0r - g0i], -1))
        xi = xi.index_add(-1, at, -0.5 * torch.cat([g0r - g0i, g0r + g0i], -1))
        return xr, xi

    @staticmethod
    def _pack(x) -> Planes:
        """Even samples to the real plane, odd to the imaginary."""
        return contiguous(x[..., 0::2]), contiguous(x[..., 1::2])

    @staticmethod
    def _interleave(zr, zi) -> torch.Tensor:
        return copied(torch.stack([zr, zi], dim=-1).reshape(*zr.shape[:-1], 2 * zr.shape[-1]))

    def _rfft(self, x) -> Planes:
        n = self.spec.n
        x = _real(x, self.device, "rfft")
        ax = self._last_axis(x.ndim)
        if ax is not None:
            x = x.movedim(ax, -1)
        if x.shape[-1] != n:
            raise PlanError(f"rfft planned for n={n}, got axis length {x.shape[-1]}")
        (inner,) = self.children
        if n % 2:
            # Odd length: the full complex transform (a Bluestein child),
            # sliced to the n//2 + 1 Hermitian bins.
            zr, zi = inner.apply_planes(x, torch.zeros_like(x))
            xr, xi = contiguous(zr[..., : n // 2 + 1]), contiguous(zi[..., : n // 2 + 1])
        else:
            zr, zi = inner.apply_planes(*self._pack(x))
            xr, xi = self._recomb(zr, zi)
        if ax is not None:
            xr, xi = xr.movedim(-1, ax), xi.movedim(-1, ax)
        return xr, xi

    def _irfft(self, x) -> torch.Tensor:
        n = self.spec.n
        xr, xi, _ = _split(x, self.device)
        ax = self._last_axis(xr.ndim)
        if ax is not None:
            xr, xi = xr.movedim(ax, -1), xi.movedim(ax, -1)
        if xr.shape[-1] != n // 2 + 1:
            raise PlanError(f"irfft expects n//2+1={n // 2 + 1} bins, got {xr.shape[-1]}")
        (inner,) = self.children
        if n % 2:
            # Odd length: the Hermitian extension to the full spectrum, the
            # complex inverse (a Bluestein child), its real part.
            zr = torch.cat([xr, torch.flip(xr[..., 1:], (-1,))], dim=-1)
            zi = torch.cat([xi, -torch.flip(xi[..., 1:], (-1,))], dim=-1)
            out, _ = inner.apply_planes(zr, zi)
        else:
            zr, zi = inner.apply_planes(*self._recomb(xr, xi))
            out = self._interleave(zr, zi)
        return out.movedim(-1, ax) if ax is not None else out

    def _rfft2(self, x) -> Planes:
        """Packed row transform, the recombination row-wise, then the
        complex column pass over the (…, n2, n/2 + 1) half-spectrum (numpy's
        ``rfft2`` layout)."""
        x = _real(x, self.device, "rfft2")
        self._check_image(x)
        inner, cols = self.children
        zr, zi = inner.apply_planes(*self._pack(x))
        return cols.apply_planes(*self._recomb(zr, zi))

    def _irfft2(self, x) -> torch.Tensor:
        """Inverse of :meth:`_rfft2`: column ifft over the half-spectrum,
        the inverse recombination row-wise, the packed row ifft, the sample
        interleave."""
        n, n2 = self.spec.n, self.spec.n2
        xr, xi, _ = _split(x, self.device)
        if xr.ndim < 2 or tuple(xr.shape[-2:]) != (n2, n // 2 + 1):
            raise PlanError(f"irfft2 expects (..., {n2}, {n // 2 + 1}) bins, got {tuple(xr.shape)}")
        inner, cols = self.children
        xr, xi = cols.apply_planes(xr, xi)
        zr, zi = inner.apply_planes(*self._recomb(xr, xi))
        return self._interleave(zr, zi)

    @tracing.span("fft.call")
    def __call__(self, x, check: Optional[str] = None):
        """Execute the planned transform.

        ``check`` arms an opt-in numerics guard over the result, read on the
        host after the call: ``"nan"`` raises :class:`NumericsError` on a
        non-finite output value; ``"parseval"`` checks energy conservation
        (complex kinds) at :data:`PARSEVAL_RTOL`."""
        kind = self.spec.kind
        if check is not None:
            if check not in _CHECKS:
                raise PlanError(
                    f"unknown numerics check {check!r}; expected 'nan' or 'parseval'",
                    spec=self.spec, backend=self.backend.name,
                )
            if check == "parseval" and kind not in _COMPLEX_KINDS + ("fft2", "ifft2"):
                raise PlanError(
                    f'check="parseval" covers the complex kinds, not {kind!r}',
                    spec=self.spec, backend=self.backend.name,
                )
        if kind == "rfft":
            out = self._rfft(x)
        elif kind == "irfft":
            out = self._irfft(x)
        elif kind == "rfft2":
            out = self._rfft2(x)
        elif kind == "irfft2":
            out = self._irfft2(x)
        else:
            xr, xi, was_c = _split(x, self.device)
            out = _join(*self.apply_planes(xr, xi), was_c)
        if check is not None:
            self._run_check(x, out, check)
        return out

    def _run_check(self, x, out, check: str) -> None:
        """The numerics guard ``check`` over ``out`` (and ``x`` for Parseval)."""
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        if check == "nan":
            if not all(bool(torch.isfinite(a).all()) for a in outs):
                raise NumericsError(
                    "non-finite values in planned FFT output",
                    spec=self.spec, backend=self.backend.name, check="nan",
                )
            return
        ins = list(x) if isinstance(x, (tuple, list)) else [x]
        e_in, e_out = _energy(ins), _energy(outs)
        scale = self.spec.n * (self.spec.n2 or 1)
        expected = e_in * scale if self.spec.kind in ("fft", "fft2") else e_in / scale
        if not np.isclose(e_out, expected, rtol=PARSEVAL_RTOL, atol=1e-30):
            raise NumericsError(
                f"Parseval energy mismatch: output {e_out:.6g}, expected "
                f"{expected:.6g} (rtol {PARSEVAL_RTOL})",
                spec=self.spec, backend=self.backend.name, check="parseval",
            )


class _PassProgram(torch.autograd.Function):
    """A plan's complex pass program as one autograd leaf: planes in, planes
    out.  Every plan form computes an exact DFT, whose adjoint is the
    opposite direction's transform unnormalised: the same plan run the
    other way and scaled by the transform's size (``fft`` → N·``ifft``,
    ``ifft`` → ``fft``/N, N = n·n2 for the 2-D kinds; the inverse's 1/N is
    folded into its tables).  It saves no tensor."""

    @staticmethod
    def forward(ctx, xr, xi, planned: "PlannedFFT", inverse: bool, axis: int):
        ctx.planned, ctx.inverse, ctx.axis = planned, inverse, axis
        return planned.backend.fn(xr, xi, inverse=inverse, planned=planned, axis=axis)

    @staticmethod
    def backward(ctx, gr, gi):
        planned = ctx.planned
        size = planned.spec.n * (planned.spec.n2 or 1)
        scale = 1.0 / size if ctx.inverse else float(size)
        yr, yi = planned._run(gr, gi, not ctx.inverse, ctx.axis)
        return yr * scale, yi * scale, None, None, None


class _HalfProgram(torch.autograd.Function):
    """One half of a 2-D plan's program (the row passes, ``axis=-1``, or the
    column passes, ``axis=-2``) as one autograd leaf: as
    :class:`_PassProgram`, the adjoint is the same half run the other way,
    scaled by its length (n for the rows, n2 for the columns)."""

    @staticmethod
    def forward(ctx, xr, xi, planned: "PlannedFFT", inverse: bool, axis: int):
        ctx.planned, ctx.inverse, ctx.axis = planned, inverse, axis
        return planned._half_planes(xr, xi, inverse, axis)

    @staticmethod
    def backward(ctx, gr, gi):
        planned = ctx.planned
        size = planned.spec.n if ctx.axis == -1 else planned.spec.n2
        scale = 1.0 / size if ctx.inverse else float(size)
        yr, yi = planned._run_half(gr, gi, not ctx.inverse, ctx.axis)
        return yr * scale, yi * scale, None, None, None


class _Recomb(torch.autograd.Function):
    """The Hermitian recombination pass ``kind`` (with phasor ``luts``; the
    plan's own when empty) as one autograd leaf; the backward is
    :meth:`PlannedFFT._recomb_adjoint` of the pass that ran.  It saves no
    tensor."""

    @staticmethod
    def forward(ctx, ar, ai, planned: "PlannedFFT", kind: str, luts: tuple):
        ctx.planned, ctx.kind = planned, kind
        return planned._recomb_pass(ar, ai, kind, luts or planned.luts)

    @staticmethod
    def backward(ctx, gr, gi):
        return (*ctx.planned._recomb_adjoint(ctx.kind, gr, gi), None, None, None)


def _energy(arrays) -> float:
    """Σ|z|² over tensors or host arrays, real or complex, in float64: split
    planes sum to the same energy as the complex array they hold."""
    total = 0.0
    for a in arrays:
        t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        t = t.to(torch.complex128) if t.is_complex() else t.to(torch.float64)
        total += float((t.abs() ** 2).sum())
    return total


# ---------------------------------------------------------------------------
# plan()
# ---------------------------------------------------------------------------


def _resolve_device(device) -> torch.device:
    if fake.active():  # the dry run: every device is the simulated card
        return fake.card()
    if device is None:
        if not torch.cuda.is_available():
            raise PlanError(
                "no CUDA device: plan() runs on the card; pass device='cpu' "
                "to run the plain PyTorch route instead"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise PlanError(f"device {device} requested but no CUDA device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _check_slice(spec: FFTSpec) -> None:
    """Raise for a spec the port does not execute: only float32 is ported.
    Any length plans, as the reference's: past ``FUSED_MAX²`` the program
    ends in the reorder pass, and only a Bluestein pad past
    ``fused_max²`` raises (the planner's own ``NotImplementedError``)."""
    if spec.precision != "float32":
        raise NotImplementedError(f"precision {spec.precision!r}: only float32 is ported")


@tracing.span("fft.plan")
def plan(spec: FFTSpec | int, *, device=None, tune: Optional[str] = None,
         backend: Optional[str] = None) -> PlannedFFT:
    """Resolve ``spec`` into an interned :class:`PlannedFFT`.

    ``device=None`` means the current CUDA device and raises when there is
    none; ``device="cpu"`` runs the plain route.  ``backend=None`` takes the
    innermost :func:`use_backend` scope, then ``REPRO_FFT_BACKEND``, then
    the device's own backend; a backend that does not run on the device
    raises :class:`PlanError` (there is no fallback).  ``tune`` picks how
    the program's knobs are chosen, as the reference's: ``"off"`` the fixed
    heuristics, ``"model"`` (the default, also through ``REPRO_FFT_TUNE``)
    the roofline model's pick with no measurement, ``"measure"`` the winner
    of the model's survivors timed once on the card and kept in the
    persistent tuning cache (:mod:`repro_torch.core.tuning`).  Plans are
    interned per (spec, device, mode, backend).
    """
    from repro_torch.core import tuning  # lazy: tuning plans through this module

    if isinstance(spec, int):
        spec = FFTSpec(n=spec)
    mode = tuning.resolve_mode(tune)
    _check_slice(spec)
    dev = _resolve_device(device)
    name = backend if backend is not None else default_backend()
    return _plan_cached(spec, str(dev), mode, _backend_for(dev, name).name)


#: Ring-buffer capacity of the plan log.
PLAN_LOG_MAX = 1024

#: Every (FFTSpec, backend name) :func:`_plan_cached` created, in creation
#: order, the last :data:`PLAN_LOG_MAX` of them.  A cache hit does not log,
#: so the entries after a snapshot are exactly the plans an operation
#: forced: how the tests show that overlap-save never plans past
#: ``FUSED_MAX`` and that a warm decode plans nothing.
_PLAN_LOG: collections.deque = collections.deque(maxlen=PLAN_LOG_MAX)


def plan_log() -> tuple:
    """Snapshot of the most recent (spec, backend name) pairs planned in
    this process (oldest first)."""
    return tuple(_PLAN_LOG)


def clear_plan_log() -> None:
    """Empty the plan log (not the plan cache: existing handles stay
    interned)."""
    _PLAN_LOG.clear()


@fake.device_cache(maxsize=256)
def _plan_cached(spec: FFTSpec, device: str, tune: str = "model",
                 backend: Optional[str] = None) -> PlannedFFT:
    planned = _build_plan(spec, device, tune, backend)
    _PLAN_LOG.append((spec, planned.backend.name))
    return planned


def _tuned_plan(spec: FFTSpec, entry: Backend, dev: torch.device, tune: str):
    """The program of a complex or 2-D complex spec under ``tune`` and the
    config it came from: the card's backend builds it from
    :func:`~repro_torch.core.tuning.plan_config` and checks its forms
    against the block's shared memory here, at plan time."""
    from repro_torch.core import limits, tuning
    from repro_torch.kernels import ops  # lazy: ops imports the kernels

    cfg = tuning.plan_config(spec, entry.name, tune, device=dev)
    knobs = cfg or {}
    fused_max = knobs.get("fused_max", plan_lib.FUSED_MAX)
    direct_max = knobs.get("direct_max", plan_lib.DIRECT_MAX)
    if spec.n2 is not None:
        # ONE joint program: rows, then the columns in place (strip-mined
        # beyond the fused regime, to n2 = FUSED_MAX²).
        fft_plan = plan_lib.plan_fft2(spec.n, spec.n2, fused_max, direct_max)
    else:
        fft_plan = plan_lib.plan_fft(spec.n, fused_max, direct_max, pad=knobs.get("bluestein_pad"))
    if cfg:
        forms = {int(k): int(v) for k, v in cfg.get("forms", {}).items()}
        ops.check_forms(fft_plan, forms, -2 if spec.axis == -2 else -1, limits.memory_budget(dev))
    return fft_plan, cfg


def _build_plan(spec: FFTSpec, device: str, tune: str = "model",
                backend: Optional[str] = None) -> PlannedFFT:
    from repro_torch.kernels import ops  # lazy: ops imports the kernels

    dev = torch.device(device)
    entry = _backend_for(dev, backend)
    kind = spec.kind
    if kind in _COMPLEX_KINDS or (kind in ("fft2", "ifft2") and plan_lib.joint2d_supported(spec.n2)):
        fft_plan, cfg = _tuned_plan(spec, entry, dev, tune)
        inverse = kind in ("ifft", "ifft2")
        luts = ops.plan_luts(fft_plan, inverse, dev)
        return PlannedFFT(spec, entry, fft_plan, dev, luts, tuned=cfg)

    inverse = kind in ("irfft", "irfft2", "ifft2")

    def child(n: int, axis: int = -1, batch_hint: Optional[int] = None) -> PlannedFFT:
        return _plan_cached(
            FFTSpec(n=n, kind="ifft" if inverse else "fft", axis=axis, batch_hint=batch_hint), device, tune,
            entry.name,
        )

    if kind in ("fft2", "ifft2"):
        # Columns past the strip-mined gate (n2 > FUSED_MAX²): the row plan
        # and the axis=-2 column plan, composed, as the reference does.
        return PlannedFFT(spec, entry, None, dev, children=(child(spec.n), child(spec.n2, axis=-2)))

    if kind in ("rfft", "irfft") and spec.n % 2:
        # Odd length: the even/odd packing needs an even split, so the real
        # transform runs as one full-length complex Bluestein child (imaginary
        # plane zero) sliced to the n//2 + 1 bins: no recombination epilogue.
        return PlannedFFT(spec, entry, None, dev, children=(child(spec.n, batch_hint=spec.batch_hint),))
    m = spec.n // 2
    bins = (1, 1, m + 1)
    epilogue = plan_lib.Pass(
        kind="irfft_recomb" if inverse else "rfft_recomb",
        n=spec.n,
        view_in=bins if inverse else (1, 1, m),
        view_out=(1, 1, m) if inverse else bins,
        order="natural",
    )
    luts = ops.recomb_luts(ops.device_key(dev), spec.n, inverse)
    # The packed row transform sees the caller's batch; rfft2 / irfft2's
    # column child runs in place over the m + 1 bins.
    if kind in ("rfft", "irfft"):
        children = (child(m, batch_hint=spec.batch_hint),)
    else:
        children = (child(m), child(spec.n2, axis=-2))
    return PlannedFFT(spec, entry, None, dev, luts, children=children, epilogue=epilogue)


# ---------------------------------------------------------------------------
# Built-in backends
# ---------------------------------------------------------------------------


def _pass_program(xr, xi, *, inverse, planned, axis=-1):
    """Execute the plan's passes; each kernel wrapper launches its CUDA
    kernel on a CUDA tensor and takes its plain version on a CPU one."""
    from repro_torch.kernels import ops

    return ops.execute_plan(xr, xi, planned.fft_plan, inverse=inverse, axis=axis, forms=planned.forms)


register_backend("torch", _pass_program, {"cpu"})
register_backend("cuda", _pass_program, {"cuda"})


# ---------------------------------------------------------------------------
# Plan-cached convenience wrappers
# ---------------------------------------------------------------------------


def _device_of(x):
    a = x[0] if isinstance(x, (tuple, list)) else x
    return a.device if torch.is_tensor(a) else None


def _shape(x) -> tuple:
    a = x[0] if isinstance(x, (tuple, list)) else x
    return tuple(a.shape) if torch.is_tensor(a) else np.shape(a)


def fft(x: ArrayOrPlanes, *, axis: int = -1, backend: Optional[str] = None) -> ArrayOrPlanes:
    """Complex FFT over ``axis`` via a cached plan, on the input tensor's
    device (host arrays go to the card); ``backend`` as :func:`plan`'s."""
    spec = FFTSpec(n=int(_shape(x)[axis]), kind="fft", axis=axis)
    return plan(spec, device=_device_of(x), backend=backend)(x)


def ifft(x: ArrayOrPlanes, *, axis: int = -1, backend: Optional[str] = None) -> ArrayOrPlanes:
    """Inverse of :func:`fft`."""
    spec = FFTSpec(n=int(_shape(x)[axis]), kind="ifft", axis=axis)
    return plan(spec, device=_device_of(x), backend=backend)(x)


def rfft(x, *, axis: int = -1, backend: Optional[str] = None) -> Planes:
    """Real FFT: the n//2 + 1 bins over ``axis`` as split planes."""
    spec = FFTSpec(n=int(_shape(x)[axis]), kind="rfft", axis=axis)
    return plan(spec, device=_device_of(x), backend=backend)(x)


def irfft(x, n: int, *, axis: int = -1, backend: Optional[str] = None) -> torch.Tensor:
    """Inverse of :func:`rfft`; the length-``n`` real signal."""
    return plan(FFTSpec(n=n, kind="irfft", axis=axis), device=_device_of(x), backend=backend)(x)


def fft2(x: ArrayOrPlanes, *, backend: Optional[str] = None) -> ArrayOrPlanes:
    """2-D FFT over the last two axes: one joint rows + columns program."""
    shape = _shape(x)
    spec = FFTSpec(n=int(shape[-1]), kind="fft2", n2=int(shape[-2]))
    return plan(spec, device=_device_of(x), backend=backend)(x)


def ifft2(x: ArrayOrPlanes, *, backend: Optional[str] = None) -> ArrayOrPlanes:
    """Inverse of :func:`fft2`."""
    shape = _shape(x)
    spec = FFTSpec(n=int(shape[-1]), kind="ifft2", n2=int(shape[-2]))
    return plan(spec, device=_device_of(x), backend=backend)(x)


def rfft2(x, *, backend: Optional[str] = None) -> Planes:
    """Real 2-D FFT of an (..., n2, n) image: (..., n2, n//2 + 1) bins as
    split planes (numpy's ``rfft2`` layout)."""
    shape = _shape(x)
    spec = FFTSpec(n=int(shape[-1]), kind="rfft2", n2=int(shape[-2]))
    return plan(spec, device=_device_of(x), backend=backend)(x)


def irfft2(x, n: int, n2: int, *, backend: Optional[str] = None) -> torch.Tensor:
    """Inverse of :func:`rfft2`; the real (..., n2, n) image."""
    return plan(FFTSpec(n=n, kind="irfft2", n2=n2), device=_device_of(x), backend=backend)(x)
