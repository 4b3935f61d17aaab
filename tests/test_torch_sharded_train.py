"""The sharded train step on four gloo ranks on the CPU, against the port's
one-device step.

One module fixture spawns four rank processes once (``torch.distributed``
over gloo, a ``file://`` rendezvous in a temporary directory, timeouts on
the group and the processes); they run every case of ``tests/_sharded.py``
— the reference's parity config (2 layers, d 64, 4 heads, kv 2, ff 128,
vocab 512, loss_chunk 16) plain and with ``use_spectral_mixer`` at meshes
2×2 with FSDP, 4×1 and 1×4; Adafactor, int8 gradient compression and two
microbatches at 2×2; a 4-expert top-2 MoE at 2×2 with the experts over
``model`` — 4 steps each, then an elastic save at 2×2 and restore at 4×1,
and the launcher with ``--mesh 2x2`` and ``--mesh 3x1``.  Each rank writes
its results, a sharded tensor as its own chunk and layout, and this
process joins them (no collective beyond the steps' own); meanwhile it
runs the same cases on one device.

The reference's own sharded step cannot serve here: under jax 0.9.0 it
raises ``ShardingTypeError`` in the embedding gather even at mesh (1, 1)
(``tests/test_sharding.py``'s parity test fails on this host), and the
one-device step is held against the reference by ``test_torch_train.py``.

Tolerances: the first step's gradients (the loss on batch 0 and its
backward through the shards and their reductions) within 1e-5·max|one
device| per tensor; losses and metrics of every step 1e-5 relative; each
final tensor within 1e-5·max|one device| (sums taken in another order
over the shards) but for at most 4 elements of a tensor, which stay within
the learning rate: AdamW's step is m̂/(√v̂ + eps), at step 1 exactly
g/(|g| + eps), so an element whose gradient nearly cancels to 0 turns its
last-ulp differences into a share of a step (``test_torch_train.py`` says
the same of the port against the reference), and with int8 compression
an element within an ulp of a rounding midpoint rounds to the other code,
one quantum (max|g|/127) apart, which the error-feedback residual then
keeps (the residuals are held as the test says).
"""

import concurrent.futures
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _sharded as S
from conftest import SRC
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import train as launch_train

WORLD = 4
TIMEOUT = 180  # seconds, for the ranks
TOL = 1e-5
LAUNCH = ["--arch", "h2o-danube-1.8b", "--reduced", "--steps", "2", "--batch", "4", "--seq", "32",
          "--device", "cpu", "--log-every", "100"]
TESTS = os.path.dirname(os.path.abspath(__file__))

_RANK = r"""
import datetime, json, os, sys
import numpy as np, torch, torch.distributed as dist

rank, world, tmp, tests = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, tests)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "rendezvous"), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=120))
import _sharded as S
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh, parallel_config_for
from repro_torch.sharding import shard

out, meshes = {}, {}


def mesh_of(shape):
    if shape not in meshes:
        meshes[shape] = make_mesh(shape, ("data", "model"), device="cpu")
    return meshes[shape]


def keep(prefix, state):
    for k, v in S.state_arrays(state).items():
        out[f"{prefix}/{k}"] = v


for name, (cfg, shape, fsdp, kw) in S.CASES.items():
    tc = S.train_config(**kw)
    mesh = mesh_of(shape)
    par = parallel_config_for(mesh, fsdp=fsdp)
    state = S.fresh(cfg, tc, mesh, par)
    for k, v in S.first_grads(state, tc).items():
        out[f"{name}/{k}"] = v
    shard.reset_counts()
    state, out[f"{name}/metrics"], out[f"{name}/dropped"] = S.steps(state, cfg, tc, 0, S.STEPS)
    out[f"{name}/collectives"] = np.array(json.dumps(shard.counts()))
    out[f"{name}/predicted"] = np.array(json.dumps(shard.step_collectives(
        state.model, S.DATA.seq_len, tc.microbatches, tc.grad_compression)))
    keep(name, state)
    if name == "dense-2x2-fsdp":
        saved = (state, tc)

# elastic: save at 2x2, step on (straight); restore at 4x1 and step
state, tc = saved
mgr = CheckpointManager(os.path.join(tmp, "ckpt"))
mgr.save(S.STEPS, state, extra={"data_step": S.STEPS})
state, out["elastic/straight/metrics"], _ = S.steps(state, S.PARITY, tc, S.STEPS, 1)
keep("elastic/straight", state)
mesh = mesh_of((4, 1))
restored, extra = mgr.restore(S.STEPS, S.fresh(S.PARITY, tc, mesh, parallel_config_for(mesh)))
out["elastic/4x1/step"] = np.array([restored.step, restored.opt_state.step, extra["data_step"]])
keep("elastic/4x1/restored", restored)
restored, out["elastic/4x1/metrics"], _ = S.steps(restored, S.PARITY, tc, S.STEPS, 1)
keep("elastic/4x1", restored)

# ann: a DTensor activation redistributed to the rule's placements
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.sharding.logical import ann, mesh_context
mesh = mesh_of((2, 2))
x = torch.arange(8 * 6, dtype=torch.float32).view(8, 6)
with mesh_context(mesh, parallel_config_for(mesh)):
    y = ann(DTensor.from_local(x, mesh, [Replicate(), Replicate()]), "batch", "embed")
    same = ann(x, "batch", "embed") is x
out["ann"] = np.array([str(y.placements), same, torch.equal(y.to_local(), x.chunk(2)[mesh.get_local_rank(0)])],
                      dtype=object).astype(str)

# the launcher inside the ranks
out["launch/losses"] = np.array(launch_train.main(LAUNCH + ["--mesh", "2x2"]))
try:
    launch_train.main(LAUNCH + ["--mesh", "3x1"])
    out["launch/3x1"] = np.array("no error")
except ValueError as err:
    out["launch/3x1"] = np.array(str(err))
np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
dist.destroy_process_group()
print("RANK_OK")
"""


def _run_ranks(tmp) -> dict:
    script = os.path.join(tmp, "rank.py")
    with open(script, "w") as f:
        f.write(f"LAUNCH = {LAUNCH!r}\n" + _RANK)
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, script, str(r), str(WORLD), tmp, TESTS], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:  # a hung or surviving rank is killed, never waited out
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "RANK_OK" in log, f"rank {r} failed:\n{log}"
    ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(WORLD)]
    return {k: S.join(ranks, k) for k in ranks[0] if "@" not in k}


def _one_device() -> dict:
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank: one core's share, whatever else runs
    try:
        for name, (cfg, _, _, kw) in S.CASES.items():
            tc = S.train_config(**kw)
            state = S.fresh(cfg, tc)
            out.update({f"{name}/{k}": v for k, v in S.first_grads(state, tc).items()})
            state, out[f"{name}/metrics"], out[f"{name}/dropped"] = S.steps(state, cfg, tc, 0, S.STEPS)
            out.update({f"{name}/{k}": v for k, v in S.state_arrays(state).items()})
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sharded"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_run_ranks, tmp)
        one = _one_device()
        return ranks.result(), one, tmp


def _close(got, want, name, tol=TOL):
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1e-30), f"{name}: max|Δ| {err:.3e} vs max {np.abs(want).max():.3e}"


def _close_but_few(got, want, name):
    """Within 1e-5·max|want| but for at most 4 elements, which stay within
    the learning rate (see the module's docstring)."""
    far = np.abs(got - want) > TOL * max(np.abs(want).max(), 1e-30)
    assert far.sum() <= 4, f"{name}: {far.sum()} of {far.size} elements differ"
    assert np.abs(got - want).max() <= S.train_config().learning_rate, name


def _metrics_close(got, want, name):
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("case", list(S.CASES))
def test_sharded_step_equals_one_device(run, case):
    ranks, one, _ = run
    _metrics_close(ranks[f"{case}/metrics"], one[f"{case}/metrics"], case)
    keys = [k for k in one if k.startswith(f"{case}/") and k.count("/") >= 2]
    assert keys and set(keys) == {k for k in ranks if k.startswith(f"{case}/") and k.count("/") >= 2}
    for key in keys:
        got, want = ranks[key], one[key]
        assert got.shape == want.shape, key
        if "/grad/" in key or "adafactor" in case:
            _close(got, want, key)
        elif "/err/" in key:
            # A residual is g − deq(q(g)), |e| ≤ half a quantum q = max|g|/127,
            # and every dequantised value moves with the leaf's scale: held to
            # 1e-5 of the gradient's scale (254·max|e|), but for the codes a
            # flip moved (each by a quantum, ≤ 2·max|e|, and it stays in the
            # residual), at most 1e-3 of them.
            bound = np.abs(want).max()
            far = np.abs(got - want) > TOL * 254 * bound
            assert far.mean() <= 1e-3 and np.abs(got - want).max() <= 4 * bound, (key, far.sum())
        else:
            _close_but_few(got, want, key)


def test_moe_aux_and_dropped(run):
    ranks, one, _ = run
    aux = one["moe-2x2-fsdp/metrics"][:, 2]
    assert (aux > 0).all()
    np.testing.assert_allclose(ranks["moe-2x2-fsdp/metrics"][:, 2], aux, rtol=TOL)
    assert one["moe-2x2-fsdp/dropped"].sum() > 0, "the case should drop assignments"
    np.testing.assert_array_equal(ranks["moe-2x2-fsdp/dropped"], one["moe-2x2-fsdp/dropped"])


def test_collectives_per_step_follow_the_schedule(run):
    """Each step launches the collectives ``shard.step_collectives`` predicts
    (AdamW and SGD; Adafactor's statistics reduce per leaf besides); FSDP
    gathers each unit once per run and reduce-scatters it once; the 4x1
    mesh has no model axis (only the data all-reduces) and the 1x4 mesh
    no data axis (no gather of a data shard, no reduce-scatter)."""
    ranks, _, _ = run
    counts = {case: json.loads(str(ranks[f"{case}/collectives"]))["counts"] for case in S.CASES}
    for case in S.CASES:
        if not case.startswith("adafactor"):
            want = {k: S.STEPS * v for k, v in json.loads(str(ranks[f"{case}/predicted"])).items()}
            assert counts[case] == want, case
    # remat: the forward and the recompute gather a block, the root once
    assert counts["dense-2x2-fsdp"]["all_gather"] == S.STEPS * (2 * 2 + 1)
    assert counts["dense-2x2-fsdp"]["reduce_scatter"] == S.STEPS * 3
    assert counts["microbatches-2x2-fsdp"]["reduce_scatter"] == 2 * S.STEPS * 3
    assert set(counts["dense-4x1"]) == {"all_reduce"} and set(counts["spectral-1x4"]) == {"all_reduce"}


def test_elastic_restore_across_meshes(run):
    ranks, one, tmp = run
    assert tuple(ranks["elastic/4x1/step"]) == (S.STEPS, S.STEPS, S.STEPS)
    saved = {k[len("dense-2x2-fsdp/"):]: v for k, v in ranks.items()
             if k.startswith(("dense-2x2-fsdp/param/", "dense-2x2-fsdp/opt/"))}
    restored = {k[len("elastic/4x1/restored/"):]: v for k, v in ranks.items()
                if k.startswith("elastic/4x1/restored/")}
    assert saved.keys() == restored.keys()
    for k in saved:
        np.testing.assert_array_equal(restored[k], saved[k], err_msg=k)
    # the next step: 4x1 after the restore, and 2x2 straight on
    _metrics_close(ranks["elastic/4x1/metrics"], ranks["elastic/straight/metrics"], "next step 4x1")
    for k in [k for k in ranks if k.startswith("elastic/straight/param/")]:
        _close(ranks[k.replace("straight", "4x1")], ranks[k], k)
    # and at one device, from the same files
    cfg, _, _, kw = S.CASES["dense-2x2-fsdp"]
    tc = S.train_config(**kw)
    state, extra = CheckpointManager(os.path.join(tmp, "ckpt")).restore(S.STEPS, S.fresh(cfg, tc))
    assert state.step == extra["data_step"] == S.STEPS
    for k, v in S.state_arrays(state).items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    state, metrics, _ = S.steps(state, cfg, tc, S.STEPS, 1)
    _metrics_close(metrics, ranks["elastic/straight/metrics"], "next step on one device")
    for k, v in S.state_arrays(state).items():
        if k.startswith("param/"):
            _close(v, ranks[f"elastic/straight/{k}"], k)


def test_ann_redistributes_a_dtensor(run):
    placements, same, local = ranks_ann = run[0]["ann"]
    assert placements == "(Shard(dim=0), Replicate())" and same == "True" and local == "True", ranks_ann


def test_launcher_mesh(run):
    ranks, _, _ = run
    one = launch_train.main(LAUNCH + ["--mesh", "1x1"])
    np.testing.assert_allclose(ranks["launch/losses"], one, rtol=5e-3)
    msg = str(ranks["launch/3x1"])
    assert "3" in msg and "4" in msg and "needs" in msg, msg
