"""The comparisons that decide ``correct``."""

from __future__ import annotations

import torch


def rel_max(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got − ref| / max |ref|, in float64 (complex128 for complex data)."""
    wide = torch.complex128 if got.is_complex() or ref.is_complex() else torch.float64
    ref = ref.to(wide)
    return float((got.to(wide) - ref).abs().max() / ref.abs().max())


def judged(name: str, readings: list, limit: float) -> dict:
    """The number compared for ``name``: the worst of ``readings``."""
    if not readings:
        raise ValueError(f"{name}: nothing was compared")
    return {"name": name, "value": max(readings), "limit": limit}
