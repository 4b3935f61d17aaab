"""Sharded prefill and decode on four gloo ranks on the CPU, against the
port's one-device serving and the reference's.

One module fixture spawns four rank processes once (``torch.distributed``
over gloo, a ``file://`` rendezvous in a temporary directory, timeouts on
the group and the processes); they run every case of
``tests/_serve_cases.py`` — reduced h2o-danube-1.8b with the spectral mixer
at 2×2 with FSDP and at 1×4 (one head a rank: the single kv head
replicated, each rank caching it), reduced deepseek-moe-16b with the
spectral mixer at 2×2 (experts over ``model``), reduced zamba2-2.7b at 2×2
with FSDP (Mamba2 and the shared attention block) and reduced qwen2-vl-72b
at 1×4 (int8 KV) — each a prefill of 4 prompts of 16 tokens (each rank its
rows) and 10 teacher-forced decode steps (one spectral stream flush), in
float32.  The weights are the reference's (``init_unzipped`` from a seed,
loaded by ``load_reference_model``, saved for the ranks); this process
serves the same models on one device, and the reference's ``prefill`` and
``decode_step`` (jitted) serve them too.

Held: each rank's prefill and decode logits within 1e-5·max|one device|
of its rows of the one-device run and within 1e-4·max|reference| (the
port's tolerance against the reference in float32) of its rows of the
reference's run, and the collectives of the prefill and of a decode step
equal ``shard.decode_collectives``.
"""

import concurrent.futures
import os
import subprocess
import sys

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _serve_cases as C
from conftest import SRC
from repro.configs import base as ref_base
from repro.models import model as ref_model
from repro_torch.utils.params import load_reference_model

WORLD = 4
TIMEOUT = 180  # seconds, for the ranks
TOL = 1e-5
TOL_REF = 1e-4
TESTS = os.path.dirname(os.path.abspath(__file__))

_RANK = r"""
import datetime, json, os, sys
import numpy as np, torch, torch.distributed as dist

rank, world, tmp, tests = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, tests)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "rendezvous"), rank=rank,
                        world_size=world, timeout=datetime.timedelta(seconds=120))
import _serve_cases as C
from repro_torch.launch.mesh import make_mesh, parallel_config_for
from repro_torch.sharding import shard

out, meshes = {}, {}
for name, (cfg, shape, fsdp) in C.CASES.items():
    if shape not in meshes:
        meshes[shape] = make_mesh(shape, ("data", "model"), device="cpu")
    mesh = meshes[shape]
    weights = os.path.join(tmp, f"{name}.pt")
    m = shard.shard_model(C.model(cfg, weights), mesh, parallel_config_for(mesh, fsdp=fsdp))
    prefill, steps, pc, dc = C.serve(m, C.tokens(cfg))
    out[f"{name}/prefill"], out[f"{name}/steps"] = prefill, steps
    out[f"{name}/row"] = np.array(mesh.get_local_rank(0))
    out[f"{name}/collectives"] = np.array(json.dumps([pc, dc, shard.decode_collectives(m)]))
np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
dist.destroy_process_group()
print("RANK_OK")
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


def _ref_cfg(cfg):
    """The reference's config with the port's fields (the same values)."""
    ref = ref_base.get_config(cfg.name)
    ref = type(ref)(**dataclasses.asdict(cfg))
    assert dataclasses.asdict(ref) == dataclasses.asdict(cfg)
    return ref


def _ref_serve(cfg, params, ids) -> tuple:
    """The reference's run of ``C.serve``: prefill, decode layout, STEPS
    teacher-forced decode steps (jitted)."""
    p = C.PROMPT
    lp, rc = jax.jit(lambda w, t: ref_model.prefill(w, {"tokens": t}, cfg))(params, jnp.asarray(ids[:, :p]))
    rc = ref_model.prepare_decode_caches(rc, cfg, p, p + C.STEPS)
    step = jax.jit(lambda w, tk, c, t: ref_model.decode_step(w, tk, c, t, cfg))
    steps = []
    for i in range(C.STEPS):
        lg, rc = step(params, jnp.asarray(ids[:, p + i]), rc, jnp.asarray(p + i, jnp.int32))
        steps.append(np.asarray(lg))
    return np.asarray(lp), np.stack(steps)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FFT_TUNE", "off")
        params, single, ref = {}, {}, {}
        for name, (cfg, _, _) in C.CASES.items():
            params[name] = ref_model.init_unzipped(jax.random.PRNGKey(0), _ref_cfg(cfg))[0]
            m = load_reference_model(C.model(cfg), jax.tree.map(np.asarray, params[name]))
            torch.save(m.state_dict(), tmp / f"{name}.pt")
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(_run_ranks, tmp)
            for name, (cfg, _, _) in C.CASES.items():
                single[name] = C.serve(C.model(cfg, tmp / f"{name}.pt"), C.tokens(cfg))[:2]
                ref[name] = _ref_serve(_ref_cfg(cfg), params[name], C.tokens(cfg))
            return ranks.result(), single, ref


def _rows(r, name) -> slice:
    per = C.ROWS // C.CASES[name][1][0]
    return slice(int(r[f"{name}/row"]) * per, (int(r[f"{name}/row"]) + 1) * per)


@pytest.mark.parametrize("name", list(C.CASES))
def test_sharded_prefill_and_decode_equal_one_device(runs, name):
    ranks, single, _ = runs
    want_prefill, want_steps = single[name]
    for r in ranks:
        rows = _rows(r, name)
        got_p, got_s = r[f"{name}/prefill"], r[f"{name}/steps"]
        assert got_p.shape == want_prefill[rows].shape and got_s.shape == want_steps[:, rows].shape
        np.testing.assert_allclose(got_p, want_prefill[rows], rtol=0, atol=TOL * np.abs(want_prefill).max())
        np.testing.assert_allclose(got_s, want_steps[:, rows], rtol=0, atol=TOL * np.abs(want_steps).max())


@pytest.mark.parametrize("name", list(C.CASES))
def test_sharded_prefill_and_decode_match_reference(runs, name):
    ranks, _, ref = runs
    want_prefill, want_steps = ref[name]
    for r in ranks:
        rows = _rows(r, name)
        got_p, got_s = r[f"{name}/prefill"], r[f"{name}/steps"]
        assert got_p.shape == want_prefill[rows].shape and got_s.shape == want_steps[:, rows].shape
        np.testing.assert_allclose(got_p, want_prefill[rows], rtol=0, atol=TOL_REF * np.abs(want_prefill).max())
        np.testing.assert_allclose(got_s, want_steps[:, rows], rtol=0, atol=TOL_REF * np.abs(want_steps).max())


@pytest.mark.parametrize("name", list(C.CASES))
def test_collectives_equal_decode_collectives(runs, name):
    import json

    for r in runs[0]:
        prefill, decode, predicted = json.loads(str(r[f"{name}/collectives"]))
        assert decode == predicted and prefill == predicted
        assert predicted  # every case's mesh shards something
