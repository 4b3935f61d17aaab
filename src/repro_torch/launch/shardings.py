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
parameter is allocated.  :func:`abstract_params` and
:func:`abstract_train_state` are the model and its train state on the meta
device, what the dry run (:mod:`repro_torch.launch.dryrun`) traces after
making them fake.  :func:`cache_shardings` gives each layer's decode cache
the reference's spec (its rules at ``src/repro/launch/shardings.py:149``,
less the leading repeats axis of the reference's stacked caches), and
:func:`local_caches` cuts a rank's shard of each layer's cache by those
specs as the port's layers hold it: rows and slots as the spec splits
them, kv heads over ``model`` where the spec puts them there and else the
kv heads the rank's query heads read (where the spec puts ``head_dim``
over ``model``, ``ROADMAP.md`` C), the int8 scales' slots as their k's.
"""

from __future__ import annotations

import functools

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.sharding import partition
from repro_torch.sharding.partition import spec_for_shape

__all__ = ["abstract_params", "abstract_train_state", "param_count", "param_specs", "train_state_shardings",
           "batch_shardings", "cache_shardings", "meta_caches", "local_caches", "local_range"]


@functools.lru_cache(maxsize=32)
def _abstract(cfg: ModelConfig):
    """(name → shape, name → logical axes, reference leaves) of ``cfg``'s
    model, built on the meta device."""
    from repro_torch.models.model import DecoderLM
    from repro_torch.utils.params import param_axes, reference_leaves

    model = DecoderLM(cfg, device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return shapes, param_axes(model), reference_leaves(model)


def abstract_params(cfg: ModelConfig):
    """(name → meta tensor, name → logical axes) of ``cfg``'s parameters,
    without allocating anything."""
    from repro_torch.models.model import DecoderLM
    from repro_torch.utils.params import param_axes

    model = DecoderLM(cfg, device="meta")
    return dict(model.named_parameters()), param_axes(model)


def abstract_train_state(cfg: ModelConfig, train_cfg):
    """A :class:`~repro_torch.train.train_loop.TrainState` on the meta
    device: the model, its optimizer state and its compression residuals."""
    from repro_torch.train.train_loop import init_train_state

    return init_train_state(cfg, train_cfg, device="meta")


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


def _axis_size(mesh, names) -> int:
    return partition.axis_size(mesh, names)


def cache_shardings(cfg: ModelConfig, mesh, par: ParallelConfig, caches) -> list:
    """Each layer's decode-cache specs, by the reference's rules: a cache of
    the same type whose fields are specs (``()`` for a non-tensor field).
    KV (B, S, KV, hd): batch over the data axes where divisible, kv heads
    over ``model``; else head_dim over ``model`` when the batch took
    ``data``; else the sequence over (data, model) as far as it divides.
    The int8 scales (B, S, KV) follow the kv heads or replicate.  Recurrent
    and spectral states (B, ...): batch over data, their widest dim that
    ``model`` divides over it."""
    batch_axes = (par.pod_axis, par.data_axis) if par.pod_axis else (par.data_axis,)
    batch_axes = tuple(a for a in batch_axes if a)
    model_ax = par.model_axis
    m = _axis_size(mesh, model_ax)
    # a spec entry names one axis as a string, several as a tuple
    batch_entry = batch_axes if len(batch_axes) > 1 else batch_axes[0]

    def div(n, names):
        return n % _axis_size(mesh, names) == 0

    def kv_spec(t):
        if t.dim() == 3:  # int8 scale planes (B, S, KV)
            b, s, kv = t.shape
            b_sh = batch_entry if div(b, batch_axes) else None
            return (b_sh, None, model_ax if kv % m == 0 else None)
        b, s, kv, hd = t.shape
        b_sh = batch_entry if div(b, batch_axes) else None
        if kv % m == 0:
            return (b_sh, None, model_ax, None)
        if b_sh is not None and hd % m == 0:
            return (b_sh, None, None, model_ax)
        seq_axes = (model_ax,) if b_sh is not None else batch_axes + (model_ax,)
        while seq_axes and not div(s, seq_axes):
            seq_axes = seq_axes[1:]
        if seq_axes:
            return (b_sh, seq_axes if len(seq_axes) > 1 else seq_axes[0], None, None)
        return (b_sh, None, None, None)

    def generic_spec(t):
        shape = t.shape
        if len(shape) == 0:
            return ()
        b_sh = batch_entry if div(shape[0], batch_axes) else None
        entries = [b_sh] + [None] * (len(shape) - 1)
        best, best_dim = None, 0
        for i in range(1, len(shape)):
            if shape[i] % m == 0 and shape[i] > best_dim:
                best, best_dim = i, shape[i]
        if best is not None:
            entries[best] = model_ax
        return tuple(entries)

    out = []
    for cache in caches:
        specs = {}
        for name, t in cache._asdict().items():
            if not hasattr(t, "shape"):
                specs[name] = ()
            elif name in ("k", "v", "k_scale", "v_scale"):
                specs[name] = kv_spec(t)
            else:
                specs[name] = generic_spec(t)
        out.append(type(cache)(**specs))
    return out


@functools.lru_cache(maxsize=8)
def _meta_model(cfg: ModelConfig):
    from repro_torch.models.model import DecoderLM

    return DecoderLM(cfg, device="meta")


def meta_caches(cfg: ModelConfig, batch: int, max_len: int, dtype) -> list:
    """Every layer's decode cache for the global batch of ``batch`` rows and
    ``max_len`` positions, on the meta device (the shapes alone)."""
    return _meta_model(cfg).cache_init(batch, max_len, dtype)


def local_range(entry, n: int, mesh) -> tuple:
    """(first index, count) of this rank's part of a dim of ``n`` that a
    spec entry (None, a mesh axis, or a tuple of them in order) splits."""
    if entry is None:
        return 0, n
    idx, size = 0, 1
    for axis in (entry,) if isinstance(entry, str) else entry:
        d = mesh.mesh_dim_names.index(axis)
        idx, size = idx * mesh.size(d) + mesh.get_local_rank(d), size * mesh.size(d)
    return idx * (n // size), n // size


def local_caches(model, caches) -> list:
    """This rank's shard of each layer's decode cache of the sharded
    ``model``, cut from ``caches`` (the global batch's: every row, slot, kv
    head and channel; meta tensors give the shapes alone) by
    :func:`cache_shardings`' specs as the port's layers hold them.  KV:
    rows and slots as the spec splits them (split slots come back a
    :class:`~repro_torch.models.layers.attention.SeqKVCache` holding every
    kv head), else the kv heads of ``Attention.kv_local``; the int8 scales'
    rows, slots and kv heads as their k's.  A spectral state: its rows and
    the channels of the rank's ``model`` shard; a recurrent state: its rows
    (the recurrent layers compute whole over ``model``)."""
    from repro_torch.models.layers import attention as attn_lib
    from repro_torch.models.layers.spectral import SpectralCache, SpectralStreamCache
    from repro_torch.sharding import shard

    mesh, par = model._sharding
    specs = cache_shardings(model.cfg, mesh, par, caches)
    out = []
    with shard.context(model):
        for block, cache, spec in zip(model.stack, caches, specs, strict=True):
            fields = cache._asdict()
            first = next(k for k, t in fields.items() if hasattr(t, "shape"))
            r0, rows = local_range(getattr(spec, first)[0], fields[first].shape[0], mesh)
            cut = {k: t.narrow(0, r0, rows) if hasattr(t, "shape") else t for k, t in fields.items()}
            if isinstance(cache, attn_lib.KVCache):
                s_entry = spec.k[1]
                s0, n = local_range(s_entry, cache.k.shape[1], mesh)
                k0, kv = (0, cache.k.shape[2]) if s_entry else block.mixer.kv_local()
                for k, t in cut.items():
                    if t is not None:
                        cut[k] = t.narrow(1, s0, n).narrow(2, k0, kv)
                if s_entry:
                    axes = (s_entry,) if isinstance(s_entry, str) else tuple(s_entry)
                    cache = attn_lib.SeqKVCache(**cut, start=s0, axes=axes)
                    out.append(cache)
                    continue
            elif isinstance(cache, (SpectralCache, SpectralStreamCache)):
                ch, dim = block.mixer._channels(), 2 if isinstance(cache, SpectralCache) else 1
                if ch != block.mixer.d_model:
                    cut = {k: t.narrow(dim, shard.tp().rank * ch, ch) if hasattr(t, "shape") else t
                           for k, t in cut.items()}
            out.append(type(cache)(**cut))
    return out
