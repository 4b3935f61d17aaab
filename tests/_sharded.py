"""Cases of ``test_torch_sharded_train.py``: a model and train config, a
mesh and the steps, run the same way by the four gloo ranks (sharded) and
by the test process (one device)."""

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import DataConfig, host_batch_slice, make_batch
from repro_torch.models.model import loss_fn
from repro_torch.sharding import shard
from repro_torch.train.train_loop import init_train_state, make_train_step

STEPS = 4
#: The reference's parity config (tests/test_sharding.py), at float32 compute.
PARITY = ModelConfig(family="dense", num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                     vocab_size=512, loss_chunk=16, compute_dtype="float32")
SPECTRAL = dataclasses.replace(PARITY, use_spectral_mixer=True, spectral_filter_len=16)
#: 4 experts, top 2, one shared expert, capacity for a drop or two.
MOE = dataclasses.replace(PARITY, family="moe", num_experts=4, top_k=2, num_shared_experts=1,
                          capacity_factor=1.0)
DATA = DataConfig(vocab_size=512, seq_len=64, global_batch=8)

#: name → (model config, mesh shape, fsdp, TrainConfig keywords)
CASES = {
    "dense-2x2-fsdp": (PARITY, (2, 2), True, {}),
    "dense-4x1": (PARITY, (4, 1), False, {}),
    "dense-1x4": (PARITY, (1, 4), False, {}),
    "spectral-2x2-fsdp": (SPECTRAL, (2, 2), True, {}),
    "spectral-4x1": (SPECTRAL, (4, 1), False, {}),
    "spectral-1x4": (SPECTRAL, (1, 4), False, {}),
    "adafactor-2x2-fsdp": (PARITY, (2, 2), True, {"optimizer": "adafactor"}),
    "compression-2x2-fsdp": (PARITY, (2, 2), True, {"grad_compression": True}),
    "microbatches-2x2-fsdp": (PARITY, (2, 2), True, {"microbatches": 2}),
    "moe-2x2-fsdp": (MOE, (2, 2), True, {}),
}


def train_config(**kw) -> TrainConfig:
    return TrainConfig(total_steps=STEPS + 2, warmup_steps=1, learning_rate=1e-3, **kw)


def fresh(cfg, tc, mesh=None, par=None):
    return init_train_state(cfg, tc, device="cpu", generator=torch.Generator().manual_seed(0), mesh=mesh, par=par)


def steps(state, cfg, tc, first: int, count: int):
    """``count`` steps from batch ``first``: (state, per-step metrics (loss,
    ce, aux, grad_norm), per-step dropped counts of the MoE layers)."""
    step = make_train_step(cfg, tc)
    metrics, dropped = [], []
    for i in range(first, first + count):
        state, met = step(state, make_batch(DATA, i))
        metrics.append([float(met[k]) for k in ("loss", "ce", "aux", "grad_norm")])
        dropped.append([int(b.moe.dropped) for b in state.model.stack if b.kind == "moe"])
    return state, np.array(metrics), np.array(dropped)


def _arrays(t) -> dict:
    """A tensor's local array and, for a ``DTensor``, the dim each mesh dim
    shards (-1: replicated) and this rank's mesh coordinate: the test
    joins the ranks' chunks, so no collective gathers them."""
    lay = shard.layout(t)
    out = {"": shard.local(t).detach().numpy().copy()}
    if lay is not None:
        mesh, dims = lay
        out["@dims"] = np.array([-1 if d is None else d for d in dims])
        out["@coord"] = np.array(mesh.get_coordinate())
    return out


def state_arrays(state) -> dict:
    """Every tensor of a train state (this rank's chunks of a sharded one,
    see :func:`_arrays`)."""
    tensors = {f"param/{n}": p for n, p in state.model.named_parameters()}
    inner = state.opt_state.inner
    for k, group in (inner.items() if isinstance(inner, dict) else ()):
        tensors.update({f"opt/{k}/{n}": t for n, t in group.items()})
    tensors.update({f"err/{n}": t for n, t in state.err_state.items()})
    return {k + suffix: a for k, t in tensors.items() for suffix, a in _arrays(t).items()}


def first_grads(state, tc) -> dict:
    """The gradient of the loss on batch 0 at ``state`` (this rank's rows of
    it on a sharded model; its chunks, see :func:`_arrays`)."""
    model, batch = state.model, make_batch(DATA, 0)
    if shard.is_sharded(model):
        mesh, par = model._sharding
        dim = mesh.mesh_dim_names.index(par.data_axis)
        batch = host_batch_slice(batch, mesh.get_local_rank(dim), mesh.size(dim))
    names, params = zip(*model.named_parameters())
    loss, _ = loss_fn(model, batch, tc)
    grads = torch.autograd.grad(loss, params)
    return {f"grad/{n}" + suffix: a for n, g in zip(names, grads) for suffix, a in _arrays(g).items()}


def join(ranks: list, key: str) -> np.ndarray:
    """The whole tensor ``key`` from the ranks' chunks (:func:`_arrays`):
    each rank's chunk joined along the dims its mesh dims shard, the last
    mesh dim first, as ``shard.local_chunk`` cut it."""
    if f"{key}@dims" not in ranks[0]:
        return ranks[0][key]
    dims = [int(d) for d in ranks[0][f"{key}@dims"]]
    parts = {tuple(int(c) for c in r[f"{key}@coord"]): r[key] for r in ranks}
    for i in reversed(range(len(dims))):
        merged = {}
        for coord in sorted(parts):
            head = coord[:i]
            if dims[i] < 0:
                merged.setdefault(head, parts[coord])
            else:
                merged[head] = parts[coord] if head not in merged else np.concatenate(
                    [merged[head], parts[coord]], axis=dims[i])
        parts = merged
    return parts[()]
