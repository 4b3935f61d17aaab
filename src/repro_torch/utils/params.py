"""Parameter initialisation, and the reference's parameters carried into the
port's modules.

The reference keeps parameters as a pytree of ``Param`` leaves;
``unzip(tree)[0]`` gives the plain values, a nested dict of arrays.  This
module fills a ``torch.nn.Module`` from such a dict, name for name, in the
reference's layouts (a projection ``w`` of shape (in, out) is applied as
``x @ w`` on both sides, so nothing is transposed).  :func:`normal` draws a
parameter at the reference's law (``repro/utils/params.py:92``); :func:`cast`
is a parameter at its use in the compute dtype.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.runtime import tracing

__all__ = [
    "normal",
    "cast",
    "load_reference_params",
    "load_reference_model",
    "load_reference_train_state",
    "reference_leaves",
    "param_axes",
]


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


def cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w.to(dtype)``: a parameter cast at its use, as the reference writes
    ``params[...].astype(cd)``.  A cast that copies (``w`` in another dtype)
    counts ``weight_cast.count`` and ``weight_cast.bytes``, the bytes of
    ``w``, while tracing is on."""
    if w.dtype != dtype:
        tracing.count("weight_cast.count")
        tracing.count("weight_cast.bytes", w.numel() * w.element_size())
    return w.to(dtype)


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


def reference_leaves(module: nn.Module) -> dict:
    """The reference's parameter leaves of ``module``: each of its flattened
    names (``stack.unit.b{i}.<name>`` for a layer's parameter, stacked over
    the repeats of the pattern's unit; every other name as it is, the shared
    block's ``stack.shared.<name>`` among them, one unstacked leaf however
    many layers use it) → the port's parameter names that make it up, in
    repeat order, and whether it is stacked.  The optimizer and the
    gradient compression reduce over a reference leaf (a stacked leaf's
    norm or scale spans its repeats), so they work on these groups."""
    from repro_torch.models.stack import find_unit  # the models import this module

    cfg = getattr(module, "cfg", None)
    width = len(find_unit(cfg.pattern())) if cfg is not None else 1
    leaves = {}
    for name, _ in module.named_parameters():
        if not name.startswith("stack.") or name.startswith("stack.shared."):
            leaves[name] = (False, (name,))
            continue
        layer, _, rest = name[len("stack."):].partition(".")
        key = f"stack.unit.b{int(layer) % width}.{rest}"
        leaves[key] = (True, leaves.get(key, (True, ()))[1] + (name,))
    return leaves


#: The reference's logical axes of each parameter, by the port's module
#: class and attribute (the reference's ``Param(value, axes)`` of each
#: layer's init).  A plain array leaf of the reference (a norm's scale) is
#: replicated: ``(None,) * ndim``.
AXES = {
    "Embedding": {"table": ("vocab", "embed")},
    "Head": {"w": ("embed", "vocab")},
    "Attention": {"wq": ("embed", "heads", "head_dim"), "wk": ("embed", "kv_heads", "head_dim"),
                  "wv": ("embed", "kv_heads", "head_dim"), "wo": ("heads", "head_dim", "embed")},
    "MLP": {"wi_gate": ("embed", "ff"), "wi_up": ("embed", "ff"), "wo": ("ff", "embed")},
    "MoE": {"router": ("embed", "experts"), "wi_gate": ("experts", "embed", "expert_ff"),
            "wi_up": ("experts", "embed", "expert_ff"), "wo": ("experts", "expert_ff", "embed")},
    "SpectralMixer": {"filt": ("embed", "filter"), "w_gate": ("embed", "ff"), "w_in": ("embed", "ff"),
                      "w_out": ("ff", "embed")},
    "Mamba2": {"w_in": ("embed", "ff"), "conv_w": ("conv", "ff"), "conv_b": ("ff",), "a_log": ("heads",),
               "dt_bias": ("heads",), "d_skip": ("heads",), "w_out": ("ff", "embed")},
    "MLSTM": {"w_up": ("embed", "ff"), "w_qkv": ("ff", "ff"), "w_if": ("ff", "heads"), "b_if": ("heads",),
              "w_down": ("ff", "embed")},
    "SLSTM": {"w_x": ("embed", "ff"), "w_h": ("embed", "ff"), "bias": ("ff",), "w_out": ("embed", "embed")},
}


def param_axes(module: nn.Module) -> dict:
    """The reference's logical axes of each of ``module``'s parameters, by
    the port's names: a layer's without the ``"layers"`` axis the
    reference's stack prepends (the port keeps one parameter per layer;
    :func:`reference_leaves` gives the stacked leaves)."""
    out = {}
    for prefix, sub in module.named_modules():
        table = AXES.get(type(sub).__name__, {})
        for name, p in sub.named_parameters(prefix=prefix, recurse=False):
            attr = name.rpartition(".")[2]
            out[name] = table.get(attr, (None,) * p.dim())
    return out


def _unstacked(values: Mapping, width: int) -> dict:
    """Flattened reference values with each stacked ``stack.unit.b{i}.<name>``
    split into its repeats: repeat ``r`` of position ``i`` is the port's
    layer ``r·width + i``."""
    out = {}
    for name, value in values.items():
        if not name.startswith("stack.unit.b"):
            out[name] = value
            continue
        pos, _, rest = name[len("stack.unit.b"):].partition(".")
        stacked = np.asarray(value)
        for r in range(stacked.shape[0]):
            out[f"stack.{r * width + int(pos)}.{rest}"] = stacked[r]
    return out


def load_reference_model(model: nn.Module, tree: Mapping) -> nn.Module:
    """Copy the reference's whole-model values ``tree`` (``init_unzipped(key,
    cfg)[0]`` of the reference's ``models/model.py``) into a
    :class:`repro_torch.models.model.DecoderLM`.

    The reference stacks each position ``i`` of the pattern's repeating unit
    over the repeats (``stack.unit.b{i}.<name>``, a leading ``layers``
    axis, split on that axis only: an expert weight stacked over the
    repeats is (R, E, D, F)); repeat ``r`` of position ``i`` is the port's
    layer ``r·len(unit) + i`` (``stack.<layer>.<name>``).  Every other name
    carries over as it is: the shared block's ``stack.shared.<name>`` (whose
    positions hold an empty ``stack.unit.b{i}``) too.  As
    :func:`load_reference_params`, every name and shape must match, or it
    raises; returns ``model``."""
    from repro_torch.models.stack import find_unit  # the models import this module

    return _load(model, _unstacked(_flatten(tree), len(find_unit(model.cfg.pattern()))))


def _copy_into(dest: Mapping, values: Mapping, what: str) -> None:
    """Copy each of ``values`` into the tensor of the same name in ``dest``;
    the names and shapes must match exactly."""
    if set(dest) != set(values):
        raise KeyError(f"{what}: names differ: missing {sorted(set(dest) - set(values))}, "
                       f"unexpected {sorted(set(values) - set(dest))}")
    with torch.no_grad():
        for name, t in dest.items():
            value = torch.from_numpy(np.array(values[name], dtype=np.float32))
            if tuple(value.shape) != tuple(t.shape):
                raise ValueError(f"{what} {name}: reference shape {tuple(value.shape)}, port {tuple(t.shape)}")
            t.copy_(value.to(t.device, t.dtype))


def load_reference_train_state(state, ref):
    """The reference's ``TrainState`` ``ref`` (with numpy arrays for its
    leaves) into the port's
    :class:`~repro_torch.train.train_loop.TrainState` ``state``, in place:
    the parameters (unstacked as :func:`load_reference_model`), the
    optimizer's state (AdamW's m and v unstacked per parameter; Adafactor's
    factored statistics per reference leaf, stacked as the reference keeps
    them; SGD's none), the error-feedback residuals per reference leaf, and
    both step counters.  Returns the state with the reference's steps."""
    from repro_torch.models.stack import find_unit
    from repro_torch.train.optimizer import OptState

    model = state.model
    load_reference_model(model, ref.params)
    inner = state.opt_state.inner
    if isinstance(inner, Mapping) and set(inner) == {"m", "v"}:
        width = len(find_unit(model.cfg.pattern()))
        for k in ("m", "v"):
            _copy_into(inner[k], _unstacked(_flatten(ref.opt_state.inner[k]), width), f"opt_state {k}")
    elif inner:
        flat = {f"{leaf}.{stat}": t for leaf, stats in inner.items() for stat, t in stats.items()}
        _copy_into(flat, _flatten(ref.opt_state.inner), "opt_state")
    if state.err_state or (ref.err_state is not None and len(ref.err_state)):
        _copy_into(state.err_state, _flatten(ref.err_state), "err_state")
    opt = OptState(step=int(np.asarray(ref.opt_state.step)), inner=inner)
    return state._replace(step=int(np.asarray(ref.step)), opt_state=opt)
