"""The dry run (``repro_torch.launch.dryrun``) against the reference's.

The fake process group lives in one subprocess spawned once for the module
(as ``test_torch_distributed.py`` spawns its ranks), so no default group
leaks into other tests on the same worker; the reference's dry-run module
sets its 512-device ``XLA_FLAGS`` at import, so its functions run in one
JAX subprocess too.  Held:

* ``_fft_plan_info`` of all 7 fftbench shapes at model 16 against the
  reference's (its ``gpu_reports`` aside: the ``pallas_gpu`` backend is
  not ported): every key and byte count; the seconds differ by design (the
  H100's rates, not the TPU's), and the pencil's chunk count is the
  port's model's pick at the H100's rates, so the all-to-all count is held
  to that K (2K + 1 natural, 2K in pencil layout);
* ``active_params`` and ``param_count`` of every LM arch;
* the collectives of a 2×2 train record (reduced h2o-danube-1.8b with the
  spectral mixer, FSDP, two microbatches) equal ``shard.step_collectives``;
* at 1×1 with remat off the reduced train step's dot flops within 1 % of
  the reference's HLO walk (``src/repro/analysis/hlo.py``) of its unsharded
  jitted step (FFT backend ``xla``: no FFT runs as a dot), naming the ops;
* ``cache_shardings`` of five archs at full size against the reference's
  on stub meshes (its specs as data: the port's per-layer spec is the
  reference's less the leading repeats axis);
* a ``run_cell`` artifact carries the reference's record keys
  (``trace_s`` for ``compile_s``, its XLA-only fields left out);
* a spectral decode cell records the stream's flush step and the cycle's
  mean step; long_500k traces ``ok`` (its one sequence replicated over
  ``data``), and ``main`` counts every error as a failure.
"""

import json
import os
import subprocess
import sys

import pytest
from jax.sharding import PartitionSpec

from conftest import SRC, run_in_subprocess
from repro.configs import base as ref_base
from repro.configs import specs as ref_specs
from repro.launch import shardings as ref_sh
from repro_torch.configs import base
from repro_torch.configs import fftbench as fb
from repro_torch.configs import specs
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as sh

TIMEOUT = 300

_PORT = r"""
import dataclasses, json, sys, warnings
warnings.filterwarnings("ignore")
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import base, fftbench as fb
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.reduce import make_reduced
from repro_torch.analysis.trace import trace
from repro_torch.core import fake
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import parallel_config_for
from repro_torch.sharding import shard

out = {}
with FakeTensorMode():
    out["plan_info"] = {s.name: dryrun._fft_plan_info(s, 16) for s in fb.FFT_SHAPES}

cfg = make_reduced(dataclasses.replace(base.get_config("h2o-danube-1.8b"), use_spectral_mixer=True))
shape = ShapeConfig("t", 64, 8, "train")
tc = TrainConfig(microbatches=2)
rec = dryrun.trace_cell(cfg, shape, (2, 2), tc, fsdp=True)
with dryrun.fake_group(4):
    mesh = dryrun._mesh((2, 2))
    with FakeTensorMode():
        model = dryrun._fake_model(cfg, mesh, parallel_config_for(mesh, fsdp=True, sequence_parallel=True))
        out["predicted"] = shard.step_collectives(model, 64, 2)
out["record_2x2"] = rec

for name, spectral in (("plain", False), ("spectral", True)):
    flat = make_reduced(dataclasses.replace(base.get_config("h2o-danube-1.8b"), use_spectral_mixer=spectral))
    flat = dataclasses.replace(flat, remat=False, compute_dtype="float32")
    out[f"record_1x1/{name}"] = dryrun.trace_cell(flat, ShapeConfig("t", 64, 4, "train"), (1, 1),
                                                  TrainConfig(microbatches=1))
    with dryrun.fake_group(1):
        mesh = dryrun._mesh((1, 1))
        with FakeTensorMode():
            model = dryrun._fake_model(flat, mesh, parallel_config_for(mesh))
            toks = torch.empty(4, 64, dtype=torch.long, device=fake.card())
            out[f"forward_1x1/{name}"] = trace(model.logits_fn, toks)[1].dot_flops

cfg = make_reduced(dataclasses.replace(base.get_config("h2o-danube-1.8b"), use_spectral_mixer=True))
out["decode_2x2"] = dryrun.trace_cell(cfg, ShapeConfig("d", 64, 4, "decode"), (2, 2))

dryrun.ART_DIR = sys.argv[1]
out["run_cell"] = {f"{a}/{s}": dryrun.run_cell(a, s, False, force=True)
                   for a, s in (("fftbench", "table1_4096"), ("xlstm-125m", "decode_32k"),
                                ("xlstm-125m", "long_500k"))}
json.dump(out, open(sys.argv[2], "w"))
print("PORT_OK")
"""

_REF = r"""
import dataclasses, json
import jax, jax.numpy as jnp
from repro.analysis.hlo import analyze
from repro.configs.base import TrainConfig, get_config, list_archs
from repro.configs.reduce import make_reduced
from repro.core import fft as ref_fft
from repro.core.conv import fft_conv
from repro.launch import dryrun, shardings as sh
from repro.models.model import logits_fn
from repro.train.train_loop import init_train_state, make_train_step
import repro.configs.fftbench as fb

out = {"params": {}}
for a in list_archs():
    c = get_config(a)
    if c.family != "fft":
        out["params"][a] = [sh.param_count(c), dryrun.active_params(c)]
info = {}
for s in fb.FFT_SHAPES:
    i = dryrun._fft_plan_info(s, 16)
    i.pop("gpu_reports", None)
    info[s.name] = i
out["plan_info"] = info

tc = TrainConfig(microbatches=1)
for name, spectral in (("plain", False), ("spectral", True)):
    cfg = make_reduced(dataclasses.replace(get_config("h2o-danube-1.8b"), use_spectral_mixer=spectral))
    cfg = dataclasses.replace(cfg, remat=False, compute_dtype="float32")
    with ref_fft.use_backend("xla"):
        state = jax.eval_shape(lambda k: init_train_state(k, cfg, tc), jax.ShapeDtypeStruct((2,), jnp.uint32))
        batch = {k: jax.ShapeDtypeStruct((4, 64), jnp.int32) for k in ("tokens", "targets")}
        hlo = jax.jit(make_train_step(cfg, tc)).lower(state, batch).compile().as_text()
        fwd = jax.jit(lambda p, b: logits_fn(p, b, cfg)).lower(state.params, batch).compile().as_text()
    out[f"train_1x1/{name}"] = analyze(hlo).dot_flops
    out[f"forward_1x1/{name}"] = analyze(fwd).dot_flops
    if spectral:
        # One spectral layer's convolution alone: its xla leaves' DFT-matrix
        # products, counted apart from the port's forward.
        u = jax.ShapeDtypeStruct((4, 64, cfg.d_model), jnp.float32)
        filt = jax.ShapeDtypeStruct((cfg.d_model, cfg.spectral_filter_len), jnp.float32)
        with ref_fft.use_backend("xla"):
            conv = jax.jit(lambda u, f: fft_conv(u, f, axis=1)).lower(u, filt).compile().as_text()
        out["conv_1x1"] = [analyze(conv).dot_flops, cfg.pattern().count("spectral")]
print("REF_JSON" + json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "PYTHONPATH": SRC}
    port = subprocess.Popen([sys.executable, "-c", _PORT, str(tmp / "art"), str(tmp / "port.json")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ref_out = run_in_subprocess(_REF, devices=1, timeout=TIMEOUT)
    stdout, stderr = port.communicate(timeout=TIMEOUT)
    assert port.returncode == 0 and "PORT_OK" in stdout, stderr[-3000:]
    ref = json.loads(ref_out.split("REF_JSON", 1)[1])
    with open(tmp / "port.json") as f:
        return json.load(f), ref


def _no_seconds(x):
    """``x`` without its modelled seconds (keys ending in ``_s``), which
    divide by the card's rates where the reference's divide by the TPU's."""
    if isinstance(x, dict):
        return {k: _no_seconds(v) for k, v in x.items() if not k.endswith("_s")}
    if isinstance(x, list):
        return [_no_seconds(v) for v in x]
    return x


@pytest.mark.parametrize("name", [s.name for s in fb.FFT_SHAPES])
def test_fft_plan_info_equals_reference(runs, name):
    port, ref = runs[0]["plan_info"][name], runs[1]["plan_info"][name]
    assert sorted(port) == sorted(ref)
    kind = next(s.kind for s in fb.FFT_SHAPES if s.name == name)
    if "pencil_schedule" in port:
        head, ref_head = port.pop("pencil_schedule").split("\n")[0], ref.pop("pencil_schedule").split("\n")[0]
        k = int(head.split("(K=")[1].split(")")[0])
        assert port.pop("a2a_count") == 2 * k + (kind != "fftconv")
        ref.pop("a2a_count")
        # the factors, packing, wire and local bytes: the reference's
        cut = lambda h: h.split("; packed")[0] + h.split("comm")[1]  # noqa: E731
        assert cut(head) == cut(ref_head)
    assert _no_seconds(port) == _no_seconds(ref)


@pytest.mark.parametrize("arch", [a for a in base.list_archs() if a != "fftbench"])
def test_active_params_equal_reference(runs, arch):
    cfg = base.get_config(arch)
    assert [sh.param_count(cfg), dryrun.active_params(cfg)] == runs[1]["params"][arch]


def test_train_collectives_equal_step_collectives(runs):
    rec = runs[0]["record_2x2"]
    assert rec["status"] == "ok", rec.get("error")
    counted = {k: int(v) for k, v in rec["per_chip"]["collective_count_by_type"].items()}
    assert counted == runs[0]["predicted"]
    assert rec["train"] == {"optimizer": "adamw", "microbatches": 2}
    assert rec["per_chip"]["collective_bytes"] > 0 and rec["roofline"]["collective_s"] > 0


@pytest.mark.parametrize("name", ["plain", "spectral"])
def test_train_dot_flops_equal_reference(runs, name):
    """The reduced h2o-danube-1.8b step at 1×1, remat off: its dot flops
    within 1 % of the reference's HLO walk.  With the spectral mixer the
    reference's ``xla`` FFT leaves compute their DFTs as matrix products,
    which its walk counts as dots and the port's FFT kernels are not: those
    products, counted on the reference's convolution alone at the layer's
    shapes, once a spectral layer in the forward and twice in the step
    (each and its input's gradient; the DFT matrix is a constant)."""
    port, ref = runs
    rec = port[f"record_1x1/{name}"]
    assert rec["status"] == "ok", rec.get("error")
    by_op = rec["per_chip"]["dot_flops_by_op"]
    train, ref_train = rec["per_chip"]["dot_flops"], ref[f"train_1x1/{name}"]
    fwd, ref_fwd = port[f"forward_1x1/{name}"], ref[f"forward_1x1/{name}"]
    assert train == 3 * fwd, ("train step vs forward", by_op)
    if name == "plain":
        dft = 0
    else:
        conv, layers = ref["conv_1x1"]
        dft = conv * layers  # the reference's DFT-matrix products
        assert conv > 0 and layers == 2, ("the reference's xla FFT leaves: DFT-matrix dots", conv, layers)
    assert fwd + dft == ref_fwd, ("forward: mm and bmm", fwd, dft, ref_fwd)
    assert abs(train + 2 * dft - ref_train) <= 0.01 * ref_train, ("mm and bmm", train, ref_train, by_op)
    assert rec["per_chip"]["collective_ops"] == 0  # one rank: no collective


class StubMesh:
    """A mesh for the rules alone: axis name → size."""

    def __init__(self, **shape):
        self.shape = dict(shape)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-vl-72b", "zamba2-2.7b", "xlstm-125m",
                                  "deepseek-moe-16b"])
@pytest.mark.parametrize("mesh,kw", [(StubMesh(data=16, model=16), {}),
                                     (StubMesh(pod=2, data=16, model=16), {"pod_axis": "pod"})])
def test_cache_shardings_equal_reference(monkeypatch, arch, mesh, kw):
    import jax

    monkeypatch.setattr(ref_sh, "_ns", lambda mesh, spec: spec)  # specs as data, no devices
    cfg = base.get_config(arch)
    for shape_name in ("decode_32k", "long_500k"):
        shape = base.LM_SHAPES[shape_name]
        _, caches, _ = specs.decode_state_specs(cfg, shape)
        _, ref_caches, _ = ref_specs.decode_state_specs(ref_base.get_config(arch), ref_base.LM_SHAPES[shape_name])
        port = sh.cache_shardings(cfg, mesh, base.ParallelConfig(**kw), caches)
        ref = ref_sh.cache_shardings(ref_base.get_config(arch), mesh, ref_base.ParallelConfig(**kw), ref_caches)
        unit = len(ref)
        for layer, cache in enumerate(port):
            for name, spec in cache._asdict().items():
                want = getattr(ref[layer % unit], name)
                if want is None:
                    assert getattr(caches[layer], name) is None
                    continue
                assert isinstance(want, PartitionSpec)
                assert spec == tuple(want)[1:], (shape_name, layer, name, spec, want)
        assert len(port) == len(cfg.pattern()) and jax.tree.leaves(ref)


#: The reference's record keys (src/repro/launch/dryrun.py run_cell), its
#: compile seconds as the trace's and its XLA-only fields left out.
REF_KEYS = {"arch", "shape", "mesh", "status", "compile_s", "chips", "per_chip", "fits_hbm", "roofline",
            "useful_flops", "useful_flops_frac", "active_params", "tokens_per_step"}
REF_PER_CHIP = {"flops", "dot_flops", "hbm_bytes", "collective_bytes", "collective_by_type", "collective_ops",
                "unknown_trip_loops", "xla_cost_flops", "xla_bytes_accessed", "peak_memory_bytes",
                "argument_bytes", "temp_bytes", "output_bytes", "aliased_bytes"}
XLA_ONLY = {"xla_cost_flops", "xla_bytes_accessed", "temp_bytes", "output_bytes", "aliased_bytes"}
REF_ROOFLINE = {"compute_s", "memory_s", "collective_s", "bound", "step_lower_bound_s", "balance"}


def test_spectral_decode_records_the_flush_step(runs):
    """A spectral model's decode cell (reduced h2o-danube-1.8b at 2×2)
    traces the step that flushes the streams beside the plain step: the
    flush launches the FFT kernels (#6 and #1 or #2) the plain step does
    not, both take the schedule's collectives, and the cycle's mean step
    is (C − 1) plain steps and one flush over C."""
    rec = runs[0]["decode_2x2"]
    assert rec["status"] == "ok", rec.get("error")
    flush, cycle = rec["flush_step"], rec["decode_cycle"]
    c = cycle["chunk"]
    assert c == rec["spectral_stream"]["chunk"] and c > 1
    assert rec["launches"] == {} and {"rfft_recomb", "irfft_recomb"} < set(flush["launches"])
    assert flush["per_chip"]["collective_count_by_type"] == rec["per_chip"]["collective_count_by_type"] != {}
    for key in ("hbm_bytes", "flops", "collective_bytes"):
        want = (rec["per_chip"][key] * (c - 1) + flush["per_chip"][key]) / c
        assert cycle["per_chip"][key] == pytest.approx(want, rel=1e-12), key
    assert cycle["launches"] == {k: v / c for k, v in flush["launches"].items()}
    assert flush["per_chip"]["peak_memory_bytes"] > rec["per_chip"]["peak_memory_bytes"]
    assert cycle["per_chip"]["peak_memory_bytes"] == flush["per_chip"]["peak_memory_bytes"]
    assert rec["fits_hbm"] and flush["fits_hbm"]


def test_long_context_cell_records_its_named_refusal(runs):
    """long_500k's one sequence does not split over 16 data shards: the
    batch is replicated over ``data`` and the cell traces ``ok`` (the name
    is the refusal's this cell recorded before the sequence-sharded decode
    was ported), its step gathering no weight over ``data``."""
    rec = runs[0]["run_cell"]["xlstm-125m/long_500k"]
    assert rec["status"] == "ok", rec.get("error")
    assert "refusal" not in rec and rec["fits_hbm"] and rec["tokens_per_step"] == 1
    assert not any(k.startswith("all_gather:data") for k in rec["per_chip"]["collectives_by_axis"])


def test_main_counts_only_the_named_refusal_as_refused(monkeypatch, capsys):
    """``main`` counts every record that did not trace as a failure (a
    record carrying the retired ``refusal`` key too: no error is
    refused by name any more)."""
    recs = {"a": {"status": "error", "mesh": "16x16", "refusal": "ROADMAP.md A6",
                  "error": "NotImplementedError: a batch of 1 rows over 16 data shards"},
            "b": {"status": "error", "mesh": "16x16", "error": "NotImplementedError: no fake kernel for aten::x"}}
    monkeypatch.setattr(dryrun, "run_cell", lambda arch, shape, mp, force=False: recs[shape])
    monkeypatch.setattr(dryrun, "all_cells", lambda include_fft=True: [("x", "a"), ("x", "b")])
    assert dryrun.main(["--all"]) == 2
    out = capsys.readouterr().out
    assert "REFUSED" not in out and out.count("FAIL ") == 2 and "failures=2" in out


@pytest.mark.parametrize("cell", ["fftbench/table1_4096", "xlstm-125m/decode_32k"])
def test_run_cell_artifact_has_reference_keys(runs, cell):
    rec = runs[0]["run_cell"][cell]
    assert rec["status"] == "ok", rec.get("error")
    want = (REF_KEYS - {"compile_s"}) | {"trace_s", "launches"}
    want |= {"fft_plan"} if cell.startswith("fftbench") else set()
    assert want <= set(rec) and set(rec) - want <= {"spectral_stream"}
    assert REF_PER_CHIP - XLA_ONLY <= set(rec["per_chip"])
    assert set(rec["roofline"]) == REF_ROOFLINE
    assert rec["chips"] == 256 and rec["mesh"] == "16x16" and rec["fits_hbm"]
    assert rec["per_chip"]["unknown_trip_loops"] == 0
    if cell.startswith("fftbench"):
        assert rec["launches"] and rec["per_chip"]["collective_count_by_type"] == {"all_to_all": 3.0}
