"""The port's sharding rules and specs against the reference's, as data.

``rules_for``, ``spec_for``, ``spec_for_shape``, ``check_divisible`` and
``batch_specs`` over a grid of ``ParallelConfig``s and shapes whose dims do
not all divide the mesh; then, for registered archs at full size, every
parameter's spec and AdamW's and Adafactor's state specs against
``repro.launch.shardings._param_spec_tree`` / ``_opt_spec_tree``, on stub
meshes whose ``.shape`` maps axis names to sizes (the reference's rules
read nothing else; the port builds its model on the meta device).  The
reference's stacked leaves lead with the unmapped ``"layers"`` axis; the
port's per-layer parameters are held against the rest of the spec.  No
process group and no device.
"""

import dataclasses
import itertools

import numpy as np
import pytest
from jax.sharding import PartitionSpec

from repro.configs import base as ref_base
from repro.launch import shardings as ref_sh
from repro.sharding import logical as ref_logical
from repro.sharding import partition as ref_partition
from repro_torch.configs import base
from repro_torch.launch import shardings as sh
from repro_torch.sharding import logical, partition
from repro_torch.utils.params import reference_leaves


class StubMesh:
    """A mesh for the rules alone: axis name → size."""

    def __init__(self, **shape):
        self.shape = dict(shape)


MESHES = {
    "16x16": (StubMesh(data=16, model=16), {}),
    "2x16x16 fsdp": (StubMesh(pod=2, data=16, model=16), dict(pod_axis="pod", fsdp=True)),
    "4x2": (StubMesh(data=4, model=2), {}),
}

PARS = [dict(zip(("pod_axis", "fsdp", "sequence_parallel", "decode_weight_stationary"), v))
        for v in itertools.product((None, "pod"), (False, True), (False, True), (False, True))]

AXES = ["batch", "seq", "kv_seq", "embed", "heads", "kv_heads", "head_dim", "ff", "vocab", "experts",
        "expert_ff", "state", "conv", "filter", "frames", "layers", None]


def _pars(kw):
    return base.ParallelConfig(**kw), ref_base.ParallelConfig(**kw)


# -- the reference's own three rule tests, on the port -------------------------------------------


def test_rules_single_pod():
    r = logical.rules_for(base.ParallelConfig())
    assert r["batch"] == ("data",)
    assert r["heads"] == ("model",)
    assert r["embed"] is None


def test_rules_multi_pod_fsdp():
    r = logical.rules_for(base.ParallelConfig(pod_axis="pod", fsdp=True, sequence_parallel=True))
    assert r["batch"] == ("pod", "data")
    assert r["embed"] == ("pod", "data")
    assert r["kv_seq"] == ("data",)


def test_spec_no_duplicate_mesh_axes():
    # batch uses 'data'; embed would also want 'data' → must drop it.
    spec = logical.spec_for(("batch", "seq", "embed"), base.ParallelConfig(fsdp=True))
    names = []
    for e in spec:
        if e is not None:
            names += list(e) if isinstance(e, tuple) else [e]
    assert len(names) == len(set(names))


# -- rules, specs and divisibility over a grid ----------------------------------------------------


@pytest.mark.parametrize("kw", PARS, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_rules_and_specs_equal_reference(kw):
    par, ref_par = _pars(kw)
    assert logical.rules_for(par) == ref_logical.rules_for(ref_par)
    rng = np.random.default_rng(0)
    mesh = StubMesh(pod=2, data=4, model=3)
    for _ in range(60):
        n = int(rng.integers(1, 5))
        axes = tuple(AXES[i] for i in rng.integers(0, len(AXES), n))
        assert logical.spec_for(axes, par) == tuple(ref_logical.spec_for(axes, ref_par)), axes
        shape = tuple(int(d) for d in rng.choice([1, 2, 3, 4, 6, 8, 12, 24, 7], n))
        spec = partition.spec_for_shape(axes, shape, mesh, par)
        assert spec == tuple(ref_partition.spec_for_shape(axes, shape, mesh, ref_par)), (axes, shape)
        assert partition.check_divisible(shape, spec, mesh)
        choices = [None, "data", "model", ("pod", "data")]
        other = tuple(choices[i] for i in rng.integers(0, len(choices), n))
        assert partition.check_divisible(shape, other, mesh) == ref_partition.check_divisible(
            shape, PartitionSpec(*other), mesh), (shape, other)
    batch = {"tokens": np.zeros((8, 5)), "mask": np.zeros((6, 5)), "step": np.zeros(()), "odd": np.zeros((3,))}
    want = ref_partition.batch_specs(batch, mesh, ref_par)
    assert partition.batch_specs(batch, mesh, par) == {k: tuple(v) for k, v in want.items()}


def test_placements_for():
    from torch.distributed.tensor import Replicate, Shard

    class Dims:
        mesh_dim_names = ("pod", "data", "model")

    assert partition.placements_for(("model", None, ("pod", "data")), Dims()) == [Shard(2), Shard(2), Shard(0)]
    assert partition.placements_for((None, "data"), Dims()) == [Replicate(), Shard(1), Replicate()]


# -- whole archs at full size ---------------------------------------------------------------------

ARCHS = ["h2o-danube-1.8b", "deepseek-moe-16b", "arctic-480b", "qwen2-vl-72b", "zamba2-2.7b"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _ref_cfg(cfg):
    return ref_base.ModelConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_state_specs_equal_reference(arch):
    cfg = base.get_config(arch)
    ref_cfg = _ref_cfg(cfg)
    assert sh.param_count(cfg) == ref_sh.param_count(ref_cfg)
    leaves = reference_leaves(_model(cfg))
    for label, (mesh, kw) in MESHES.items():
        par, ref_par = _pars(kw)
        ref_params = {k: tuple(v) for k, v in _flat(ref_sh._param_spec_tree(ref_cfg, mesh, ref_par)).items()}
        specs = sh.param_specs(cfg, mesh, par)
        for leaf, (stacked, names) in leaves.items():
            want = ref_params[leaf][1:] if stacked else ref_params[leaf]
            for name in names:
                assert specs[name] == want, (label, name)
        for opt in ("adamw", "adafactor"):
            tc = base.TrainConfig(optimizer=opt, grad_compression=True)
            ref_tc = ref_base.TrainConfig(optimizer=opt, grad_compression=True)
            state = sh.train_state_shardings(cfg, tc, mesh, par)
            ref_opt = {k: tuple(v) for k, v in _flat(ref_sh._opt_spec_tree(ref_cfg, ref_tc, mesh, ref_par)).items()}
            if opt == "adamw":
                for k in ("m", "v"):
                    for leaf, (stacked, names) in leaves.items():
                        want = ref_opt[f"{k}.{leaf}"]
                        assert all(state["opt"][k][n] == (want[1:] if stacked else want) for n in names), leaf
            else:
                got = {f"{leaf}.{stat}": spec for leaf, stats in state["opt"].items() for stat, spec in stats.items()}
                assert got == ref_opt, label
            assert state["err"] == ref_params, label


def _model(cfg):
    from repro_torch.models.model import DecoderLM

    return DecoderLM(cfg, device="meta")


def test_batch_shardings_equal_reference():
    cfg = base.get_config("h2o-danube-1.8b")
    shape = base.LM_SHAPES["train_4k"]
    batch = {"tokens": np.zeros((256, 8)), "targets": np.zeros((256, 8)), "odd": np.zeros((3, 8))}
    for mesh, kw in MESHES.values():
        par, ref_par = _pars(kw)
        # the reference's batch_shardings wraps these specs in NamedShardings of a real mesh
        want = {k: tuple(ref_partition.spec_for_shape(("batch", None), v.shape, mesh, ref_par))
                for k, v in batch.items()}
        assert sh.batch_shardings(cfg, shape, mesh, par, batch) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_stationary_param_specs_are_the_training_shards(arch):
    """The reference's decode lowering places the weights under
    ``replace(par, decode_weight_stationary=par.fsdp)`` (its
    ``_lower_decode``): on every mesh, with and without FSDP, the port's
    specs under it equal the reference's under it and the training specs
    under ``par`` themselves, so a model sharded for training decodes
    weight-stationary with no re-placement."""
    cfg = base.get_config(arch)
    ref_cfg = _ref_cfg(cfg)
    leaves = reference_leaves(_model(cfg))
    for label, (mesh, kw) in MESHES.items():
        for fsdp in (False, True):
            par, ref_par = _pars({**kw, "fsdp": fsdp})
            act = dataclasses.replace(par, decode_weight_stationary=par.fsdp)
            ref_act = dataclasses.replace(ref_par, decode_weight_stationary=ref_par.fsdp)
            ref_params = {k: tuple(v) for k, v in _flat(ref_sh._param_spec_tree(ref_cfg, mesh, ref_act)).items()}
            specs = sh.param_specs(cfg, mesh, act)
            assert specs == sh.param_specs(cfg, mesh, par), (label, fsdp)
            for leaf, (stacked, names) in leaves.items():
                want = ref_params[leaf][1:] if stacked else ref_params[leaf]
                assert all(specs[name] == want for name in names), (label, fsdp, leaf)
