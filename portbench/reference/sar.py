"""The SAR pipelines through ``torch.fft`` in float64: what the program's
images are held against.

* :func:`stripmap_image` — range compression as the correlation of each
  complex echo line with the chirp replica (lags 0 … n_rg − 1), then the
  azimuth FFT down each column, then the magnitude.
* :func:`spotlight_image` — |2-D FFT| / (n_az·n_rg) of a dechirped phase history.
* :func:`batched_fft` — the 1-D FFT of each row.

Each takes ``precision``: ``"float64"`` is the reference; ``"bfloat16"``
is the control, the same pipeline with every array between stages (the
inputs, the spectra, their product, the range-compressed scene, the
azimuth spectrum and the image) rounded to bfloat16 and the transforms
in float32.  It imports nothing of the program.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "bfloat16")


def _stage(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An array between two stages: exact in float64, rounded to bfloat16
    (each of the real and imaginary parts) in the control."""
    if precision == "float64":
        return x
    if x.is_complex():
        return torch.complex(x.real.to(torch.bfloat16).float(), x.imag.to(torch.bfloat16).float())
    return x.to(torch.bfloat16).float()


def next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def stripmap_image(raw: torch.Tensor, pulse: torch.Tensor, precision: str = "float64") -> torch.Tensor:
    """raw (n_az, n_rg) complex, pulse (Lh,) complex → |azimuth FFT of the
    range-compressed returns| (n_az, n_rg).  Range compression is the
    correlation of each line with the pulse at lags 0 … n_rg − 1 (the
    spectrum times the pulse's conjugate spectrum, at a length that covers
    n_rg + Lh − 1: no wrap)."""
    n_az, n_rg = raw.shape[-2:]
    n = next_pow2(n_rg + pulse.shape[-1] - 1)
    cd = torch.complex128 if precision == "float64" else torch.complex64
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    x = _stage(raw.to(cd), precision)
    h = _stage(pulse.to(cd), precision)
    spec = _stage(torch.fft.fft(x, n=n, dim=-1), precision)
    hspec = _stage(torch.fft.fft(h, n=n), precision)
    rc = _stage(torch.fft.ifft(_stage(spec * hspec.conj(), precision), dim=-1)[..., :n_rg], precision)
    az = _stage(torch.fft.fft(rc, dim=-2), precision)
    return _stage(az.abs(), precision)


def spotlight_image(ph: torch.Tensor, precision: str = "float64") -> torch.Tensor:
    """ph (n_az, n_rg) complex → |fft2(ph)| / (n_az·n_rg)."""
    n_az, n_rg = ph.shape[-2:]
    cd = torch.complex128 if precision == "float64" else torch.complex64
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    x = _stage(ph.to(cd), precision)
    spec = _stage(torch.fft.fft2(x), precision)
    return _stage(spec.abs() / (n_az * n_rg), precision)


def batched_fft(x: torch.Tensor, precision: str = "float64") -> torch.Tensor:
    """x (batch, n) complex → its 1-D FFT along the last axis."""
    cd = torch.complex128 if precision == "float64" else torch.complex64
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return _stage(torch.fft.fft(_stage(x.to(cd), precision), dim=-1), precision)
