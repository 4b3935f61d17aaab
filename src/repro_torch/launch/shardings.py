"""Sharding specs of the train state: parameters, optimizer state,
gradient-compression residuals and batches.

Port of ``repro/launch/shardings.py``.  A spec is a tuple with one entry
per array axis (:mod:`repro_torch.sharding.logical`), keyed by the port's
parameter names; :func:`repro_torch.sharding.partition.placements_for`
turns one into ``DTensor`` placements.  The parameters' specs come from
their logical axes (:func:`repro_torch.utils.params.param_axes`) and
shapes; AdamW's moments mirror them; Adafactor's factored statistics and
the compression residuals are per reference leaf (a layer parameter
stacked with its repeats, its spec led by the unmapped ``"layers"`` axis),
the factored ones with the reduced dim's axis dropped, as the reference's
``_opt_spec_tree``.  Everything is computed on the ``meta`` device: no
parameter is allocated.  The decode caches' specs (``cache_shardings``)
serve the reference's dry run and wait with it (``ROADMAP.md`` A8).
"""

from __future__ import annotations

import functools

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.sharding import partition
from repro_torch.sharding.partition import spec_for_shape

__all__ = ["param_count", "param_specs", "train_state_shardings", "batch_shardings"]


@functools.lru_cache(maxsize=32)
def _abstract(cfg: ModelConfig):
    """(name → shape, name → logical axes, reference leaves) of ``cfg``'s
    model, built on the meta device."""
    from repro_torch.models.model import DecoderLM
    from repro_torch.utils.params import param_axes, reference_leaves

    model = DecoderLM(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return shapes, param_axes(model), reference_leaves(model)


def param_count(cfg: ModelConfig) -> int:
    shapes, _, _ = _abstract(cfg)
    return sum(functools.reduce(lambda a, b: a * b, s, 1) for s in shapes.values())


def param_specs(cfg: ModelConfig, mesh, par: ParallelConfig) -> dict:
    """Parameter name → spec."""
    shapes, axes, _ = _abstract(cfg)
    return partition.param_specs(axes, shapes, mesh, par)


def _leaves(cfg: ModelConfig):
    """Reference leaf → (its logical axes, its shape): a stacked leaf's led
    by ``"layers"`` and its repeat count."""
    shapes, axes, leaves = _abstract(cfg)
    out = {}
    for leaf, (stacked, names) in leaves.items():
        ax, shape = axes[names[0]], shapes[names[0]]
        out[leaf] = (("layers",) + ax, (len(names),) + shape) if stacked else (ax, shape)
    return out


def _opt_specs(cfg: ModelConfig, train_cfg, mesh, par: ParallelConfig):
    if train_cfg.optimizer == "sgd":
        return ()
    if train_cfg.optimizer == "adamw":
        pspecs = param_specs(cfg, mesh, par)
        return {"m": pspecs, "v": pspecs}
    out = {}
    for leaf, (ax, shape) in _leaves(cfg).items():
        if len(shape) >= 2:
            out[leaf] = {"vr": spec_for_shape(ax[:-1], shape[:-1], mesh, par),
                         "vc": spec_for_shape(ax[:-2] + ax[-1:], shape[:-2] + shape[-1:], mesh, par)}
        else:
            out[leaf] = {"v": spec_for_shape(ax, shape, mesh, par)}
    return out


def train_state_shardings(cfg: ModelConfig, train_cfg, mesh, par: ParallelConfig) -> dict:
    """The specs of a :class:`~repro_torch.train.train_loop.TrainState`'s
    tensors: ``params`` (by parameter name), ``opt`` (AdamW's ``m`` / ``v``
    by parameter name, Adafactor's ``vr`` / ``vc`` or ``v`` by reference
    leaf, SGD's none) and ``err`` (the compression residuals by reference
    leaf; empty without compression).  The step counters are replicated."""
    err = {}
    if train_cfg.grad_compression:
        err = {leaf: spec_for_shape(ax, shape, mesh, par) for leaf, (ax, shape) in _leaves(cfg).items()}
    return {"params": param_specs(cfg, mesh, par), "opt": _opt_specs(cfg, train_cfg, mesh, par), "err": err}


def batch_shardings(cfg: ModelConfig, shape, mesh, par: ParallelConfig, batch: dict) -> dict:
    """Batch dim over ('pod', 'data') where divisible; trailing dims
    replicated (seq stays unsharded for train)."""
    return {k: () if x.ndim == 0 else spec_for_shape(("batch",) + (None,) * (x.ndim - 1), tuple(x.shape), mesh, par)
            for k, x in batch.items()}
