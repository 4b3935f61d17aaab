"""Rotary position embeddings: standard (llama-style) and M-RoPE (qwen2-vl).

Port of ``repro/models/layers/rope.py``.  Callers pass integer position ids
and get rotated q/k back.  For M-RoPE, ``positions`` has shape (B, 3, S) —
(temporal, height, width) — and the rotary half-dim is partitioned into
``sections`` driven by the respective position component.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import fake

__all__ = ["apply_rope", "apply_mrope", "rope_freqs"]


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    half = head_dim // 2
    return (theta ** (-np.arange(0, half, dtype=np.float64) / half)).astype(np.float32)


@fake.device_cache(maxsize=None)
def _freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    # One upload per (head_dim, theta, device): a decode step rotates every
    # layer's q and k, and a host-to-device copy there would stall the host.
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


@fake.device_cache(maxsize=None)
def _streams_on(sections: tuple, device: torch.device) -> torch.Tensor:
    # Which of the 3 position streams drives each frequency band, uploaded
    # once per (sections, device) as the frequencies are.
    return torch.from_numpy(np.concatenate([np.full((s,), i) for i, s in enumerate(sections)])).to(device)


def _rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    # llama-style: split halves.
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _sin_cos(ang: torch.Tensor, dtype: torch.dtype):
    # sin and cos cast to x's dtype before the rotation, as the reference.
    return torch.sin(ang)[..., None, :].to(dtype), torch.cos(ang)[..., None, :].to(dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integer."""
    ang = positions.float()[..., None] * _freqs_on(x.shape[-1], theta, x.device)  # (B, S, hd/2)
    return _rotate(x, *_sin_cos(ang, x.dtype))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float, sections: Sequence[int]) -> torch.Tensor:
    """M-RoPE: x (B, S, H, hd); positions (B, 3, S) for (t, h, w).

    The half-dim frequency bands are partitioned into ``sections`` (summing
    to hd/2); band i rotates by the position component assigned to it.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to head_dim/2 = {half}")
    freqs = _freqs_on(x.shape[-1], theta, x.device)
    pos_sel = positions.float()[:, _streams_on(tuple(sections), positions.device), :]  # (B, half, S)
    ang = pos_sel.transpose(1, 2) * freqs  # (B, S, half)
    return _rotate(x, *_sin_cos(ang, x.dtype))
