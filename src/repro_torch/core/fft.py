"""Public FFT API — plan-and-execute over a backend registry.

Port of ``repro/core/fft.py`` for the planned 1-D complex power-of-two
transform::

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

``plan(spec)`` runs on the card.  Without a card it raises: it never picks
the CPU on its own.  ``plan(spec, device="cpu")`` asks for the plain route.
Nothing falls back from a kernel to its plain version or from the card to
the CPU.

Complex tensors and split ``(real, imag)`` float32 planes are both
accepted, and whichever form was supplied is returned.  The other kinds
(``rfft`` … ``irfft2``), ``axis=-2`` and non-power-of-two lengths raise
``NotImplementedError`` naming their ``ROADMAP.md`` queue item.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import plan as plan_lib
from repro_torch.core.faults import PlanError

Planes = Tuple[torch.Tensor, torch.Tensor]
ArrayOrPlanes = Union[torch.Tensor, Planes]

__all__ = [
    "FFTSpec",
    "PlannedFFT",
    "Backend",
    "plan",
    "register_backend",
    "available_backends",
    "fft",
    "ifft",
    "MAX_N",
]

KINDS = ("fft", "ifft", "rfft", "irfft", "fft2", "ifft2", "rfft2", "irfft2")
_COMPLEX_KINDS = ("fft", "ifft")
_2D_KINDS = ("fft2", "ifft2", "rfft2", "irfft2")

#: Largest length a two-pass program covers; longer pow2 lengths need the
#: digit-reversal reorder pass.
MAX_N = plan_lib.FUSED_MAX**2


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
            raise PlanError(f"{self.kind} requires a power-of-two row length, got n={self.n}")
        if self.kind in ("rfft", "irfft", "rfft2", "irfft2") and self.n < 2:
            raise PlanError(f"{self.kind} length must be >= 2, got {self.n}")
        if self.kind in _2D_KINDS:
            if self.n2 is None or not _is_pow2(self.n2):
                raise PlanError(f"{self.kind} needs a power-of-two n2 (column length), got {self.n2}")
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

    ``fn(xr, xi, *, inverse, planned)`` transforms the last axis of split
    float32 planes on ``planned.device``; ``device_types`` are the torch
    device types it runs on.
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


def _backend_for(device: torch.device) -> Backend:
    """The first registered backend that runs on ``device``'s type."""
    for entry in _REGISTRY.values():
        if device.type in entry.device_types:
            return entry
    raise PlanError(f"no registered FFT backend runs on {device}")


# ---------------------------------------------------------------------------
# Planes helpers
# ---------------------------------------------------------------------------


def _plane(a, device: torch.device) -> torch.Tensor:
    if torch.is_tensor(a):
        if a.device != device:
            raise PlanError(f"input is on {a.device}, the plan runs on {device}")
        return a.to(torch.float32)
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
        return x.real.to(torch.float32), x.imag.to(torch.float32), True
    xr = x.to(torch.float32)
    return xr, torch.zeros_like(xr), True


def _join(yr, yi, was_complex: bool) -> ArrayOrPlanes:
    return torch.complex(yr, yi) if was_complex else (yr, yi)


# ---------------------------------------------------------------------------
# PlannedFFT
# ---------------------------------------------------------------------------


class PlannedFFT:
    """A frozen, executable transform schedule on one device.

    Carries the :class:`FFTSpec`, the :class:`Backend`, the
    :class:`~repro_torch.core.plan.FFTPlan` and the device-resident LUTs of
    its passes.  Calling it runs the transform; instances are interned by
    :func:`plan`, so ``plan(spec) is plan(spec)``.
    """

    def __init__(self, spec: FFTSpec, backend: Backend, fft_plan: plan_lib.FFTPlan,
                 device: torch.device, luts: tuple):
        self.spec = spec
        self.backend = backend
        self.fft_plan = fft_plan
        self.device = device
        self.luts = luts

    def __hash__(self):
        return hash((self.spec, self.backend.name, str(self.device)))

    def __eq__(self, other):
        return (
            isinstance(other, PlannedFFT)
            and self.spec == other.spec
            and self.backend.name == other.backend.name
            and self.device == other.device
        )

    def __repr__(self):
        return f"PlannedFFT({self.spec}, backend={self.backend.name!r}, device={str(self.device)!r})"

    @property
    def passes(self) -> tuple:
        """The linearized pass program, in execution order."""
        return self.fft_plan.passes

    @property
    def hbm_round_trips(self) -> int:
        return self.fft_plan.hbm_round_trips

    @property
    def kernels(self) -> tuple:
        """The kernel each pass launches (its ``COUNTS`` key), in order."""
        from repro_torch.kernels import ops

        return tuple(ops.pass_kernel(p) for p in self.passes)

    def describe(self) -> str:
        spec = self.spec
        head = f"{spec.kind} N={spec.n} backend={self.backend.name} device={self.device}: "
        calls = ", ".join(f"pass {i} {k}" for i, k in enumerate(self.kernels))
        return head + plan_lib.describe_program(self.fft_plan) + f"; kernels: {calls}"

    def apply_planes(self, xr: torch.Tensor, xi: torch.Tensor) -> Planes:
        """Run the planned transform on split float32 planes."""
        return self.backend.fn(xr, xi, inverse=self.spec.kind == "ifft", planned=self)

    def __call__(self, x: ArrayOrPlanes) -> ArrayOrPlanes:
        xr, xi, was_c = _split(x, self.device)
        yr, yi = self.apply_planes(xr, xi)
        return _join(yr, yi, was_c)


# ---------------------------------------------------------------------------
# plan()
# ---------------------------------------------------------------------------


def _resolve_device(device) -> torch.device:
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
    """Raise for what this slice of the port does not execute yet."""
    if spec.kind in ("rfft", "irfft"):
        raise NotImplementedError(f"{spec.kind} is not ported yet: ROADMAP A4 (real FFT, kernel B5)")
    if spec.kind in _2D_KINDS:
        raise NotImplementedError(f"{spec.kind} is not ported yet: ROADMAP A5 (2-D programs)")
    if spec.axis != -1:
        raise NotImplementedError(f"axis={spec.axis} is not ported yet: ROADMAP A3 (axis=-2)")
    if not _is_pow2(spec.n):
        raise NotImplementedError(
            f"n={spec.n} is not a power of two: ROADMAP A6 (Bluestein lengths)"
        )
    if spec.n > MAX_N:
        raise NotImplementedError(
            f"n={spec.n} > 2^32 needs the reorder pass: ROADMAP A3"
        )
    if spec.precision != "float32":
        raise NotImplementedError(f"precision {spec.precision!r}: only float32 is ported")


def plan(spec: FFTSpec | int, *, device=None) -> PlannedFFT:
    """Resolve ``spec`` into an interned :class:`PlannedFFT`.

    ``device=None`` means the current CUDA device and raises when there is
    none; ``device="cpu"`` runs the plain route.  The device picks the
    backend.
    """
    if isinstance(spec, int):
        spec = FFTSpec(n=spec)
    _check_slice(spec)
    dev = _resolve_device(device)
    return _plan_cached(spec, str(dev))


@functools.lru_cache(maxsize=256)
def _plan_cached(spec: FFTSpec, device: str) -> PlannedFFT:
    from repro_torch.kernels import ops  # lazy: ops imports the kernels

    dev = torch.device(device)
    entry = _backend_for(dev)
    fft_plan = plan_lib.plan_fft(spec.n)
    luts = ops.plan_luts(fft_plan, spec.kind == "ifft", dev)
    return PlannedFFT(spec, entry, fft_plan, dev, luts)


# ---------------------------------------------------------------------------
# Built-in backends
# ---------------------------------------------------------------------------


def _pass_program(xr, xi, *, inverse, planned):
    """Execute the plan's passes; each kernel wrapper launches its CUDA
    kernel on a CUDA tensor and takes its plain version on a CPU one."""
    from repro_torch.kernels import ops

    return ops.execute_plan(xr, xi, planned.fft_plan, inverse=inverse)


register_backend("torch", _pass_program, {"cpu"})
register_backend("cuda", _pass_program, {"cuda"})


# ---------------------------------------------------------------------------
# Plan-cached convenience wrappers
# ---------------------------------------------------------------------------


def _device_of(x):
    a = x[0] if isinstance(x, (tuple, list)) else x
    return a.device if torch.is_tensor(a) else None


def _length(x) -> int:
    a = x[0] if isinstance(x, (tuple, list)) else x
    return int(a.shape[-1])


def fft(x: ArrayOrPlanes) -> ArrayOrPlanes:
    """Complex FFT over the last axis via a cached plan, on the input
    tensor's device (host arrays go to the card)."""
    return plan(FFTSpec(n=_length(x), kind="fft"), device=_device_of(x))(x)


def ifft(x: ArrayOrPlanes) -> ArrayOrPlanes:
    """Inverse of :func:`fft`."""
    return plan(FFTSpec(n=_length(x), kind="ifft"), device=_device_of(x))(x)
