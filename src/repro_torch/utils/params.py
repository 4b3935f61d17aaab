"""Carrying the reference's parameters into the port's modules.

The reference keeps parameters as a pytree of ``Param`` leaves;
``unzip(tree)[0]`` gives the plain values, a nested dict of arrays.  This
module fills a ``torch.nn.Module`` from such a dict, name for name, in the
reference's layouts (a projection ``w`` of shape (in, out) is applied as
``x @ w`` on both sides, so nothing is transposed).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["load_reference_params"]


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    """``{"a": {"b": v}}`` → ``{"a.b": v}``: the parameter names of a
    module whose submodules carry the tree's nested keys."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


def load_reference_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy the reference's parameter values ``tree`` (a nested dict of
    arrays) into ``module``'s parameters of the same dotted names, each cast
    to its parameter's dtype and device.  Every parameter must be given,
    with its exact shape, and no other name; returns ``module``."""
    values = _flatten(tree)
    params = dict(module.named_parameters())
    missing, unexpected = sorted(set(params) - set(values)), sorted(set(values) - set(params))
    if missing or unexpected:
        raise KeyError(f"parameter names differ: missing {missing}, unexpected {unexpected}")
    with torch.no_grad():
        for name, param in params.items():
            value = torch.from_numpy(np.array(values[name], dtype=np.float32))
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(
                    f"{name}: reference shape {tuple(value.shape)}, module shape {tuple(param.shape)}"
                )
            param.copy_(value.to(param.device, param.dtype))
    return module
