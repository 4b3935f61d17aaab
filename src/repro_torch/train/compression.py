"""Int8 gradient compression with error feedback.

Port of ``repro/train/compression.py``.  Each gradient is quantised to
int8 with one scale per reference leaf (a layer parameter together with its
repeats, as the reference's scanned stack holds it:
:func:`repro_torch.utils.params.reference_leaves`), and the quantisation
residual is carried into the next step (error feedback; Seide et al. 2014,
Karimireddy et al. 2019).  The dequantised values are what a data-parallel
all-reduce would move; the residuals are checkpointed with the optimizer's
state.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.utils.params import reference_leaves

__all__ = ["init_error_state", "compress_grads", "quantize_int8", "dequantize_int8"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = x.abs().max() + 1e-12
    scale = amax / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(model) -> dict:
    """A zero float32 residual per reference leaf, in its stacked shape."""
    params = dict(model.named_parameters())
    out = {}
    for leaf, (stacked, names) in reference_leaves(model).items():
        shape = ((len(names),) if stacked else ()) + tuple(params[names[0]].shape)
        out[leaf] = torch.zeros(shape, device=params[names[0]].device)
    return out


@torch.no_grad()
def compress_grads(grads: dict, err_state: dict, model) -> tuple:
    """(the dequantised gradients to feed the optimizer, the new error
    state): per reference leaf, q = int8(g + e) and e' = g + e − deq(q)."""
    out, new_err = {}, {}
    for leaf, (stacked, names) in reference_leaves(model).items():
        g = torch.stack([grads[n].float() for n in names]) if stacked else grads[names[0]].float()
        g32 = g + err_state[leaf]
        deq = dequantize_int8(*quantize_int8(g32))
        new_err[leaf] = g32 - deq
        for i, name in enumerate(names):
            out[name] = deq[i] if stacked else deq
    return out, new_err
