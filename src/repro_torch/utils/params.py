"""Parameter initialisation, and the reference's parameters carried into the
port's modules.

The reference keeps parameters as a pytree of ``Param`` leaves;
``unzip(tree)[0]`` gives the plain values, a nested dict of arrays.  This
module fills a ``torch.nn.Module`` from such a dict, name for name, in the
reference's layouts (a projection ``w`` of shape (in, out) is applied as
``x @ w`` on both sides, so nothing is transposed).  :func:`normal` draws a
parameter at the reference's law (``repro/utils/params.py:92``).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ["normal", "load_reference_params", "load_reference_model"]


def normal(
    shape: Sequence[int],
    *,
    scale: Optional[float] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> nn.Parameter:
    """A parameter drawn from N(0, 1)·``scale`` in float32, then cast to
    ``dtype`` on ``device``.  ``scale=None`` is the fan-in scaling on the
    first axis, ``shape[0] ** -0.5``.  The draws come from ``generator`` on
    its own device (the default generator of ``device`` without one)."""
    if scale is None:
        scale = shape[0] ** -0.5
    at = generator.device if generator is not None else device
    v = torch.randn(tuple(shape), generator=generator, device=at) * scale
    return nn.Parameter(v.to(device, dtype))


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


def _load(module: nn.Module, values: Mapping) -> nn.Module:
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


def load_reference_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy the reference's parameter values ``tree`` (a nested dict of
    arrays) into ``module``'s parameters of the same dotted names, each cast
    to its parameter's dtype and device.  Every parameter must be given,
    with its exact shape, and no other name; returns ``module``."""
    return _load(module, _flatten(tree))


def load_reference_model(model: nn.Module, tree: Mapping) -> nn.Module:
    """Copy the reference's whole-model values ``tree`` (``init_unzipped(key,
    cfg)[0]`` of the reference's ``models/model.py``) into a
    :class:`repro_torch.models.model.DecoderLM`.

    The reference stacks each position ``i`` of the pattern's repeating unit
    over the repeats (``stack.unit.b{i}.<name>``, a leading ``layers``
    axis); repeat ``r`` of position ``i`` is the port's layer
    ``r·len(unit) + i`` (``stack.<layer>.<name>``).  Every other name
    carries over as it is.  As :func:`load_reference_params`, every name and
    shape must match, or it raises; returns ``model``."""
    from repro_torch.models.stack import find_unit  # the models import this module

    width = len(find_unit(model.cfg.pattern()))
    values = {}
    for name, value in _flatten(tree).items():
        if not name.startswith("stack.unit.b"):
            values[name] = value
            continue
        pos, _, rest = name[len("stack.unit.b"):].partition(".")
        stacked = np.asarray(value)
        for r in range(stacked.shape[0]):
            values[f"stack.{r * width + int(pos)}.{rest}"] = stacked[r]
    return _load(model, values)
