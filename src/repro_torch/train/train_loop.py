"""Train-step factory: microbatch accumulation, compression, clipping, the
schedule and the optimizer.

Port of ``repro/train/train_loop.py``.  ``make_train_step`` builds

    train_step(state, batch) → (state, metrics)

The model in ``state`` holds the parameters and is updated in place; the
returned state carries the new step counters.  With ``microbatches > 1``
the batch is split along dim 0 and the gradients of the microbatches are
averaged; the metrics are the last microbatch's, as the reference's
``lax.scan`` carries them.  Gradients come from ``torch.autograd.grad`` of
:func:`repro_torch.models.model.loss_fn`, so on the card they run through
the FFT kernels' backward (``core/fft.py``'s autograd leaves).  Nothing is
read back to the host: the metrics are 0-d device tensors (``lr`` a float).

A sharded model (:func:`repro_torch.sharding.shard.shard_model`) takes the
same step over its mesh: every rank is given the global batch and takes
its data coordinate's rows of each microbatch
(:func:`repro_torch.data.pipeline.host_batch_slice`; microbatch i is the
global batch's i-th split, so the metrics equal one device's), and model
ranks of one data coordinate take the same rows.  The loss is the global
batch's; the backward sums the gradients over ``data`` (the units'
reduce-scatter, or an all-reduce of a replicated parameter) and the
optimizer updates each rank's shards.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.data.pipeline import host_batch_slice
from repro_torch.models import model as model_lib
from repro_torch.sharding import shard
from repro_torch.train import compression as comp_lib
from repro_torch.train.optimizer import OptState, clip_by_global_norm, make_optimizer
from repro_torch.train.schedule import make_schedule

__all__ = ["TrainState", "make_train_step", "init_train_state"]


class TrainState(NamedTuple):
    step: int
    model: model_lib.DecoderLM  # the parameters
    opt_state: OptState
    err_state: dict  # grad-compression residuals per reference leaf (empty without)


def init_train_state(cfg, train_cfg, *, device=None, generator: Optional[torch.Generator] = None,
                     mesh=None, par=None) -> TrainState:
    """A fresh model of ``cfg`` (parameters from ``generator``; the card by
    default, ``device="cpu"`` for the plain route) and its optimizer and
    error-feedback state.  With a ``mesh`` (and its ``ParallelConfig``
    ``par``) the model is sharded over it and the state is shards: every
    rank draws the same values from the same seed and keeps its own."""
    model = model_lib.DecoderLM(cfg, device=device, generator=generator)
    if mesh is not None:
        shard.shard_model(model, mesh, par)
    opt_init, _ = make_optimizer(train_cfg)
    err = comp_lib.init_error_state(model) if train_cfg.grad_compression else {}
    return TrainState(step=0, model=model, opt_state=opt_init(model), err_state=err)


def _to(batch: dict, device) -> dict:
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def make_train_step(cfg, train_cfg):
    _, opt_update = make_optimizer(train_cfg)
    schedule = make_schedule(train_cfg)
    nmicro = max(1, train_cfg.microbatches)

    def single_grads(model, batch):
        names, params = zip(*model.named_parameters())
        loss, metrics = model_lib.loss_fn(model, batch, train_cfg)
        # A parameter the loss does not reach (an audio model's embedding
        # table: frame embeddings replace the lookup) gets a zero gradient,
        # as the reference's does.
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(shard.local(p)) if g is None else shard.local(g) for p, g in zip(params, grads)]
        return dict(zip(names, grads)), {k: v.detach() for k, v in metrics.items()}

    def micro(model, batch):
        """The microbatches, this rank's rows of each."""
        b = next(iter(batch.values())).shape[0]
        shards = 1
        if shard.is_sharded(model):
            mesh, par = model._sharding
            dim = mesh.mesh_dim_names.index(par.data_axis)
            shards, index = mesh.size(dim), mesh.get_local_rank(dim)
        if b % (nmicro * shards):
            raise ValueError(f"batch of {b} rows does not split into {nmicro} microbatches "
                             f"over {shards} data shards")
        per = b // nmicro
        parts = [{k: v[i * per:(i + 1) * per] for k, v in batch.items()} for i in range(nmicro)]
        return [host_batch_slice(p, index, shards) for p in parts] if shards > 1 else parts

    def accumulated_grads(model, parts):
        acc, metrics = None, None
        for part in parts:
            grads, metrics = single_grads(model, part)
            if acc is None:
                acc = {k: g.float().clone() for k, g in grads.items()}
            else:
                for k, g in grads.items():
                    acc[k].add_(g.float())
        return {k: a / nmicro for k, a in acc.items()}, metrics

    def train_step(state: TrainState, batch: dict) -> tuple:
        model = state.model
        parts = micro(model, _to(batch, model.device))
        if nmicro > 1:
            grads, metrics = accumulated_grads(model, parts)
        else:
            grads, metrics = single_grads(model, parts[0])
        err_state = state.err_state
        if train_cfg.grad_compression:
            grads, err_state = comp_lib.compress_grads(grads, err_state, model)
        grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip, model)
        lr = schedule(state.step)
        new_opt = opt_update(grads, state.opt_state, model, lr)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return TrainState(step=state.step + 1, model=model, opt_state=new_opt, err_state=err_state), metrics

    return train_step
