"""The reference's decode sharding on four gloo ranks on the CPU: the
weight-stationary FSDP decode and the sequence-sharded KV cache, against
the port's one-device decode, the reference's and the dry run's trace.

One module fixture spawns four rank processes once (``torch.distributed``
over gloo, a ``file://`` rendezvous in a temporary directory, timeouts on
the group and the processes) and one dry-run process (a fake group of 4);
the ranks run every case of ``tests/_long_decode_cases.py`` at 2×2, each on
one device first and then sharded: a gemma3-shaped config with one kv
head (so a batch of one splits the slots over (data, model)) decoding 4
steps at the end of 256 filled slots, weight-stationary (float32 and int8
KV) and not; reduced deepseek-moe-16b and zamba2-2.7b weight-stationary
at batch 1 and 4; reduced xlstm-125m at batch 1 without it and at batch
1 and 4 with it; reduced h2o-danube-1.8b with the spectral mixer
weight-stationary at batch 4 (each state holding its data shard's rows).  The weights are the reference's (``init_unzipped``
from a seed, loaded by ``load_reference_model``), and this process runs
the reference's ``decode_step`` (jitted) over the same caches or prompts.

Held: the logits within 1e-5·max|one device| of the one-device run's rows
and within 1e-4·max|reference| of the reference's; every data rank's
logits equal where the batch is replicated; each rank's caches after the
steps equal to its shard (``local_caches``) of the one-device caches, the
recurrent states of a replicated batch whole on every rank; each step's
collectives equal ``shard.decode_collectives`` and the dry run's trace on
a fake group of 4; no weight gathered over ``data`` in a weight-stationary
step but the sLSTM's and the spectral filter; and the trace of the reduced long-context cell
(``trace_cell``) against the ranks' real step measured by the same
counter: its argument bytes, peak, collectives and launches.
"""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _long_decode_cases as C
from conftest import SRC
from repro.configs import base as ref_base
from repro.models import model as ref_model
from repro_torch.utils.params import load_reference_model

WORLD = 4
TIMEOUT = 240  # seconds, for the ranks and the trace
TOL = 1e-5
TOL_REF = 1e-4
TESTS = os.path.dirname(os.path.abspath(__file__))
#: The cases the dry run traces on a fake group of 4, and the one whose
#: record stands for a long_500k cell.
TRACED = ("gemma-seq-ws", "deepseek-ws-b1", "deepseek-ws-b4")
LONG = "gemma-seq-ws"

_RANK = r"""
import dataclasses, datetime, json, os, sys
import numpy as np, torch, torch.distributed as dist

rank, world, tmp, tests = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, tests)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "rendezvous"), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=120))
import _long_decode_cases as C
from repro_torch import kernels
from repro_torch.analysis import trace as trace_lib
from repro_torch.launch.mesh import make_mesh, parallel_config_for
from repro_torch.launch.shardings import local_caches
from repro_torch.models.layers import rope
from repro_torch.sharding import shard

mesh = make_mesh(C.MESH, ("data", "model"), device="cpu")
out = {"coords": np.array(mesh.get_coordinate())}
for name, (cfg, fsdp, ws, batch, how) in C.CASES.items():
    weights = os.path.join(tmp, C.WEIGHTS[name] + ".pt")
    one = C.run(C.model(cfg, weights), name)
    par = dataclasses.replace(parallel_config_for(mesh, fsdp=fsdp), decode_weight_stationary=ws)
    m = shard.shard_model(C.model(cfg, weights), mesh, par)
    got = C.run(m, name)
    want = local_caches(m, one["caches"])
    err = 0.0
    for g, w in zip(got["caches"], want, strict=True):
        assert type(g) is type(w), (name, type(g), type(w))
        for a, b in zip(g, w):
            if torch.is_tensor(a):
                assert a.shape == b.shape, (name, a.shape, b.shape)
                err = max(err, float((a.double() - b.double()).abs().max()))
            else:
                assert a == b, (name, a, b)
    out[f"{name}/one"], out[f"{name}/got"] = one["logits"], got["logits"]
    out[f"{name}/cache_err"] = np.array(err)
    out[f"{name}/steps"] = np.array(json.dumps({k: got[k] for k in ("counts", "predicted", "by_axis")}))
    if name == "{long}":
        # The last step again from the same caches, measured by the dry
        # run's counter on these real tensors.
        ids = C.tokens(cfg, batch)
        caches, t0 = C.start(m, name, ids)
        tok = shard.data_rows(m, torch.as_tensor(ids), decode=True)[:, C.PROMPT].clone()
        cost = trace_lib.TraceCost()
        counter = trace_lib._Counter(cost)
        for t in trace_lib.live_tensors((tok, caches, t0 + C.STEPS - 1), {}, (m,)):
            counter.track(t)
        cost.argument_bytes = counter.now
        rope._freqs_on.cache_clear()  # cold, as the trace's fresh fake mode
        before = kernels.counts()
        with counter:
            m.decode_step(tok, caches, t0 + C.STEPS - 1)
        launched = {k: v - before.get(k, 0) for k, v in kernels.counts().items() if v != before.get(k, 0)}
        out["real_step"] = np.array(json.dumps({"peak": cost.peak_memory_bytes, "argument": cost.argument_bytes,
                                                "collectives": cost.collective_count_by_type,
                                                "launches": launched}))
np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
dist.destroy_process_group()
print("RANK_OK")
""".replace("{long}", LONG)

_TRACE = r"""
import json, sys, warnings
warnings.filterwarnings("ignore")
sys.path.insert(0, sys.argv[1])
import _long_decode_cases as C
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun

out = {}
for name in json.loads(sys.argv[2]):
    cfg, fsdp, _, batch, how = C.CASES[name]
    seq = C.SLOTS if how == "filled" else C.PROMPT + C.STEPS
    out[name] = dryrun.trace_cell(cfg, ShapeConfig(name, seq, batch, "decode"), C.MESH, fsdp=fsdp)
print("TRACE " + json.dumps(out))
"""


def _run_ranks(tmp) -> list:
    env = {**os.environ, "PYTHONPATH": SRC}
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(WORLD), str(tmp), TESTS], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            p.kill()
    for p, (stdout, stderr) in zip(procs, outs):
        assert p.returncode == 0 and "RANK_OK" in stdout, stderr[-3000:]
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(WORLD)]


def _run_trace() -> dict:
    env = {**os.environ, "PYTHONPATH": SRC}
    p = subprocess.run([sys.executable, "-c", _TRACE, TESTS, json.dumps(TRACED)], env=env, capture_output=True,
                       text=True, timeout=TIMEOUT)
    line = [x for x in p.stdout.splitlines() if x.startswith("TRACE ")]
    assert p.returncode == 0 and line, p.stderr[-3000:]
    return json.loads(line[0][len("TRACE "):])


def _ref_cfg(cfg):
    """The reference's config with the port's fields (the same values)."""
    ref = type(ref_base.get_config(cfg.name))(**dataclasses.asdict(cfg))
    assert dataclasses.asdict(ref) == dataclasses.asdict(cfg)
    return ref


def _ref_caches(cfg, caches) -> list:
    """The port's per-layer caches as the reference's: one entry per
    position of the pattern's unit, each leaf stacked over the repeats."""
    from repro.models.stack import find_unit

    unit = len(find_unit(cfg.pattern()))
    like = ref_model.cache_init(cfg, caches[0].k.shape[0], caches[0].k.shape[1], jnp.float32)
    out = []
    for i, ref in enumerate(like):
        layers = caches[i::unit]
        out.append(type(ref)(**{f: None if getattr(ref, f) is None else
                                jnp.asarray(np.stack([getattr(c, f).numpy() for c in layers]))
                                for f in ref._fields}))
    return out


def _ref_run(name, params) -> np.ndarray:
    """The reference's STEPS decode steps of ``name`` (jitted): (STEPS,
    batch, vocab) logits."""
    cfg, _, _, batch, how = C.CASES[name]
    rcfg = _ref_cfg(cfg)
    ids = C.tokens(cfg, batch)
    if how == "filled":
        caches, t0 = _ref_caches(rcfg, C.fill(cfg, batch)), C.SLOTS - C.STEPS
    else:
        _, caches = jax.jit(lambda w, t: ref_model.prefill(w, {"tokens": t}, rcfg))(params, jnp.asarray(ids[:, :C.PROMPT]))
        caches, t0 = ref_model.prepare_decode_caches(caches, rcfg, C.PROMPT, C.PROMPT + C.STEPS), C.PROMPT
    step = jax.jit(lambda w, tk, c, t: ref_model.decode_step(w, tk, c, t, rcfg))
    out = []
    for i in range(C.STEPS):
        lg, caches = step(params, jnp.asarray(ids[:, C.PROMPT + i]), caches, jnp.asarray(t0 + i, jnp.int32))
        out.append(np.asarray(lg))
    return np.stack(out)


#: The reference runs: a case whose batch is the first rows of another's
#: run of the same weights reads that run's rows.
REF_OF = {"gemma-seq": "gemma-seq-ws", "deepseek-ws-b1": "deepseek-ws-b4", "zamba2-ws-b1": "zamba2-ws-b4",
          "xlstm-b1": "xlstm-ws-b4", "xlstm-ws-b1": "xlstm-ws-b4"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("long_decode")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FFT_TUNE", "off")
        params = {}
        for name, (cfg, *_) in C.CASES.items():
            key = C.WEIGHTS[name]
            if key not in params:
                params[key] = ref_model.init_unzipped(jax.random.PRNGKey(0), _ref_cfg(cfg))[0]
                m = load_reference_model(C.model(cfg), jax.tree.map(np.asarray, params[key]))
                torch.save(m.state_dict(), tmp / f"{key}.pt")
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            ranks, traced = pool.submit(_run_ranks, tmp), pool.submit(_run_trace)
            ref = {name: _ref_run(name, params[C.WEIGHTS[name]]) for name in C.CASES if name not in REF_OF}
            return ranks.result(), ref, traced.result()


def _mine(r, name, full: np.ndarray) -> np.ndarray:
    """This rank's rows of ``full`` (STEPS, batch, vocab): all of them where
    the step replicates its batch, else its data shard's."""
    rows = r[f"{name}/got"].shape[1]
    if rows == full.shape[1]:
        return full
    d = int(r["coords"][0])
    return full[:, d * rows:(d + 1) * rows]


@pytest.mark.parametrize("name", list(C.CASES))
def test_sharded_decode_equals_one_device(runs, name):
    for r in runs[0]:
        want = _mine(r, name, r[f"{name}/one"])
        assert r[f"{name}/got"].shape == want.shape
        np.testing.assert_allclose(r[f"{name}/got"], want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("name", list(C.CASES))
def test_sharded_decode_matches_reference(runs, name):
    ref = runs[1][REF_OF.get(name, name)][:, :C.CASES[name][3]]
    for r in runs[0]:
        want = _mine(r, name, ref)
        np.testing.assert_allclose(r[f"{name}/got"], want, rtol=0, atol=TOL_REF * np.abs(ref).max())


@pytest.mark.parametrize("name", list(C.CASES))
def test_replicated_batch_decodes_alike_on_every_rank(runs, name):
    """A batch of one (and a weight-stationary step's batch) is replicated
    over ``data``: every rank returns the same logits, to the last bit."""
    cfg, _, ws, batch, _ = C.CASES[name]
    got = [r[f"{name}/got"] for r in runs[0]]
    assert all(g.shape[1] == batch for g in got) == (ws or batch == 1)
    if ws or batch == 1:
        assert all(np.array_equal(g, got[0]) for g in got)


@pytest.mark.parametrize("name", list(C.CASES))
def test_cache_shards_equal_the_one_device_caches(runs, name):
    """Each rank's caches after the steps (its rows, kv heads and slots; a
    recurrent state of the replicated batch whole) equal its shard of the
    one-device caches."""
    for r in runs[0]:
        assert float(r[f"{name}/cache_err"]) <= TOL


@pytest.mark.parametrize("name", list(C.CASES))
def test_collectives_equal_decode_collectives(runs, name):
    for r in runs[0]:
        steps = json.loads(str(r[f"{name}/steps"]))
        assert steps["counts"] == steps["predicted"] and steps["counts"][0]
        gathered = {k for b in steps["by_axis"] for k in b if k.startswith("all_gather:data:weights")}
        # A weight-stationary step gathers no weight over data but the
        # sLSTM's and the spectral filter.
        if C.CASES[name][2]:
            assert bool(gathered) == (name in C.WS_GATHERS), gathered


@pytest.mark.parametrize("name", TRACED)
def test_traced_collectives_equal_the_ranks(runs, name):
    rec = runs[2][name]
    assert rec["status"] == "ok", rec.get("error")
    counts = {k: int(v) for k, v in rec["per_chip"]["collective_count_by_type"].items()}
    for r in runs[0]:
        steps = json.loads(str(r[f"{name}/steps"]))
        assert steps["counts"][-1] == counts
        assert steps["by_axis"][-1] == rec["per_chip"]["collectives_by_axis"]


def test_long_cell_trace_holds_the_real_step(runs):
    """The reduced long-context cell's trace on a fake group of 4 against
    the ranks' real last step, measured by the same counter: the bytes
    live at the start and the peak, the collectives and the launches."""
    rec = runs[2][LONG]
    pc = rec["per_chip"]
    for r in runs[0]:
        real = json.loads(str(r["real_step"]))
        assert real["argument"] == pc["argument_bytes"]
        assert real["peak"] == pc["peak_memory_bytes"]
        assert real["collectives"] == pc["collective_count_by_type"]
        assert real["launches"] == rec["launches"] == {}
    assert rec["fits_hbm"] and rec["shape"] == LONG
