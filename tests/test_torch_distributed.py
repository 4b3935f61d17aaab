"""The distributed pencil FFT on four gloo ranks on the CPU, against the
reference's ``pfft_sharded`` / ``pfft2d`` on a 4-device fake mesh and
against np.fft.

One module fixture makes the inputs from a seed, then runs, side by side,
four rank processes of the port (``torch.distributed`` over gloo, a
``file://`` rendezvous in a temporary directory, so parallel test workers
never share a port) and one JAX subprocess of the reference
(``conftest.run_in_subprocess(devices=4)``).  Each writes its results to an
``.npz``; the tests read them.  The spawn, the group and the reference all
have timeouts: a hung rank fails the module, never the suite's clock.
"""

import concurrent.futures
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import SRC, run_in_subprocess
from repro_torch.core import distributed as D
from repro_torch.core import overlap as O

WORLD = 4
TIMEOUT = 240  # seconds, for the ranks and the reference subprocess
TOL = 1e-5  # the port vs the reference, relative to max|ref|
NP_TOL = 5e-5  # vs np.fft in complex128, the reference's distributed tolerance
SIZES = (1024, 8192)
CONV = dict(L=50000, taps=257, block=1024)

_RANK = r"""
import json, os, sys
import numpy as np, torch, torch.distributed as dist
from datetime import timedelta

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "rendezvous"), rank=rank,
                        world_size=world, timeout=timedelta(seconds=120))
from repro_torch.core import distributed as D, faults

inp = np.load(os.path.join(tmp, "inputs.npz"))
out, counts = {}, {}


def shard(a, axis=-1):
    n = a.shape[axis] // world
    return np.take(a, range(rank * n, (rank + 1) * n), axis=axis)


def planes(a, axis=-1):
    s = shard(a, axis)
    return torch.from_numpy(s.real.copy()), torch.from_numpy(s.imag.copy())


def keep(key, y):
    out[key] = y[0].detach().numpy() + 1j * y[1].detach().numpy()
    counts[key] = D.counts()
    D.reset_counts()


D.reset_counts()
for n in (1024, 8192):
    x = planes(inp[f"x{n}"])
    nat = D.pfft(*x, tune="off")
    keep(f"nat{n}", nat)
    pen = D.pfft(*x, natural_order=False, tune="off")
    keep(f"pen{n}", pen)
    keep(f"penrt{n}", D.pifft(*pen, from_pencil=True, tune="off"))
    keep(f"natrt{n}", D.pifft(*nat, tune="off"))
x = planes(inp["xinv"])
keep("inv", D.pfft(*x, inverse=True, tune="off"))
img = planes(inp["img"], axis=-2)
keep("fft2d", D.pfft2d(*img, n1=128, n2=256))
keep("fft2d_unpacked", D.pfft2d(*img, n1=128, n2=256, pack=False))

# Collective counts of each schedule at n = 8192 (the reference's own test).
x = planes(inp["x8192"])
keep("nat_default", D.pfft(*x))
out["K_nat"] = np.array(D.plan_pencil(8192, world, device="cpu").a2a_chunks)
keep("pen_default", D.pfft(*x, natural_order=False))
out["K_pen"] = np.array(D.plan_pencil(8192, world, device="cpu", natural_order=False).a2a_chunks)
for k in (1, 2, 4):
    keep(f"natK{k}", D.pfft(*x, chunks=k))
keep("penK1", D.pfft(*x, natural_order=False, chunks=1))
keep("invK2", D.pifft(*x, chunks=2))
keep("nat_unpacked", D.pfft(*x, pack=False))
keep("pen_unpacked", D.pfft(*x, natural_order=False, pack=False))
keep("inv_unpacked", D.pifft(*x, pack=False))
keep("factors", D.pfft(*x, factors=(512, 16)))
x = planes(inp["x2048"])  # balanced split 64 x 32: non-square
y = D.pfft(*x, tune="off")
keep("nonsquare", y)
keep("nonsquare_rt", D.pifft(*y, tune="off"))

# The DTensor wrappers: the local path, the placement kept.
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
mesh = init_device_mesh("cpu", (world,))
xr, xi = (DTensor.from_local(t, mesh, [Shard(1)]) for t in planes(inp["x8192"]))
yr, yi = D.pfft_sharded(xr, xi)
out["dtensor_placement"] = np.array(str(yr.placements) == str(xr.placements) and yr.shape == xr.shape)
keep("dtensor", (yr.to_local(), yi.to_local()))
zr, zi = D.pifft_sharded(yr, yi)
keep("dtensor_rt", (zr.to_local(), zi.to_local()))

# Parseval: d/dx Σ|FFT(x)|² = 2n·x.
g = torch.from_numpy(shard(inp["xgrad"]).copy()).requires_grad_()
yr, yi = D.pfft(g, torch.zeros_like(g))
(yr.square().sum() + yi.square().sum()).backward()
out["grad"] = g.grad.numpy()
D.reset_counts()

y = D.pconv_os_sharded(torch.from_numpy(inp["conv_x"]), torch.from_numpy(inp["conv_h"]), block=1024)
out["conv"] = y.numpy()
counts["conv"] = D.counts()

# An injected collective fault raises on every rank, before any transfer.
os.environ["REPRO_FAULTS"] = "pencil.all_to_all:1"
faults.arm_env_faults(force=True)
try:
    D.pfft(*planes(inp["x1024"]))
    out["fault"] = np.array("none")
except faults.CollectiveError as err:
    out["fault"] = np.array(type(err).__name__)
dist.barrier()
dist.destroy_process_group()
np.savez(os.path.join(tmp, f"rank{rank}.npz"), counts=np.array(json.dumps(counts)), **out)
print("RANK_OK")
"""

_REFERENCE = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.core import distributed as D

tmp = {tmp!r}
inp = np.load(tmp + "/inputs.npz")
mesh = jax.make_mesh((4,), ("x",))
out = {{}}


def c(y):
    return np.asarray(y[0]) + 1j * np.asarray(y[1])


def sharded(fn, **kw):
    return jax.jit(lambda a, b: fn(a, b, mesh, "x", tune="off", **kw))


for n in (1024, 8192):
    x = inp[f"x{{n}}"]
    xr, xi = jnp.asarray(x.real), jnp.asarray(x.imag)
    nat = sharded(D.pfft_sharded)(xr, xi)
    out[f"nat{{n}}"] = c(nat)
    pen = sharded(D.pfft_sharded, natural_order=False)(xr, xi)
    out[f"pen{{n}}"] = c(pen)
    out[f"penrt{{n}}"] = c(sharded(D.pifft_sharded, from_pencil=True)(*pen))
    out[f"natrt{{n}}"] = c(sharded(D.pifft_sharded)(*nat))
x = inp["xinv"]
out["inv"] = c(sharded(D.pfft_sharded, inverse=True)(jnp.asarray(x.real), jnp.asarray(x.imag)))
from jax.sharding import PartitionSpec as P
img = inp["img"]
spec = P(None, "x", None)
fn = D.shard_map_compat(lambda a, b: D.pfft2d(a, b, n1=128, n2=256, axis_name="x", num_shards=4),
                        mesh, in_specs=(spec, spec), out_specs=(spec, spec))
out["fft2d"] = c(jax.jit(fn)(jnp.asarray(img.real), jnp.asarray(img.imag)))
np.savez(tmp + "/reference.npz", **out)
print("REFERENCE_OK")
"""


def _inputs(tmp) -> dict:
    rng = np.random.default_rng(2024)

    def cplx(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    inp = {f"x{n}": cplx(2, n) for n in SIZES}
    inp.update(xinv=cplx(1, 2048), img=cplx(2, 128, 256), x2048=cplx(2, 2048),
               xgrad=rng.standard_normal((2, 1024)).astype(np.float32),
               conv_x=rng.standard_normal((2, CONV["L"])).astype(np.float32),
               conv_h=rng.standard_normal(CONV["taps"]).astype(np.float32))
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    return inp


def _run_ranks(tmp) -> list:
    script = os.path.join(tmp, "rank.py")
    with open(script, "w") as f:
        f.write(_RANK)
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    env.pop("REPRO_FAULTS", None)
    procs = [subprocess.Popen([sys.executable, script, str(r), str(WORLD), tmp], env=env,
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
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(WORLD)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pencil"))
    inp = _inputs(tmp)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        reference = pool.submit(run_in_subprocess, _REFERENCE.format(tmp=tmp), 4, TIMEOUT)
        ranks = pool.submit(_run_ranks, tmp)
        ranks = ranks.result()
        assert "REFERENCE_OK" in reference.result()
    ref = dict(np.load(os.path.join(tmp, "reference.npz")))
    return inp, ranks, ref


def _joined(ranks, key, axis=-1):
    return np.concatenate([r[key] for r in ranks], axis=axis)


def _counts(ranks, key) -> dict:
    got = [json.loads(str(r["counts"]))[key] for r in ranks]
    assert all(g == got[0] for g in got), got  # every rank issues the same collectives
    return got[0]


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("n", SIZES)
def test_pfft_natural_and_pencil(run, n):
    inp, ranks, ref = run
    x = inp[f"x{n}"].astype(np.complex128)
    spec = np.fft.fft(x)
    nat = _joined(ranks, f"nat{n}")
    assert _rel(nat, ref[f"nat{n}"]) < TOL
    assert _rel(nat, spec) < NP_TOL
    pen = _joined(ranks, f"pen{n}")
    assert _rel(pen, ref[f"pen{n}"]) < TOL
    # The pencil layout's meaning: [k1, k2] holds X[k1 + n1·k2].
    n1, n2 = D.pencil_factors(n, WORLD)  # tune="off": the balanced split
    assert _rel(pen.reshape(2, n1, n2), spec.reshape(2, n2, n1).transpose(0, 2, 1)) < NP_TOL


@pytest.mark.parametrize("n", SIZES)
def test_round_trips(run, n):
    inp, ranks, ref = run
    x = inp[f"x{n}"].astype(np.complex128)
    for key in (f"penrt{n}", f"natrt{n}"):
        got = _joined(ranks, key)
        assert np.abs(got - x).max() < 5e-5 * np.abs(x).max(), key
        assert _rel(got, ref[key]) < TOL


def test_pfft_inverse(run):
    inp, ranks, ref = run
    got = _joined(ranks, "inv")
    assert _rel(got, ref["inv"]) < TOL
    assert _rel(got, np.fft.ifft(inp["xinv"].astype(np.complex128))) < NP_TOL


def test_pfft2d(run):
    inp, ranks, ref = run
    want = np.fft.fft2(inp["img"].astype(np.complex128))
    for key in ("fft2d", "fft2d_unpacked"):
        got = _joined(ranks, key, axis=-2)
        assert _rel(got, ref["fft2d"]) < TOL, key
        assert _rel(got, want) < NP_TOL, key


def test_collective_counts(run):
    _inp, ranks, _ref = run
    k_nat, k_pen = int(ranks[0]["K_nat"]), int(ranks[0]["K_pen"])
    expect = {
        "nat_default": 2 * k_nat + 1, "pen_default": 2 * k_pen,
        "natK1": 3, "natK2": 5, "natK4": 9, "penK1": 2, "invK2": 5,
        "nat_unpacked": 6, "pen_unpacked": 4, "inv_unpacked": 6,
        "fft2d": 2, "fft2d_unpacked": 4,
    }
    for key, n in expect.items():
        assert _counts(ranks, key) == {"all_to_all": n, "all_gather": 0}, key
    for natural in (True, False):
        pl = D.plan_pencil(8192, WORLD, device="cpu", natural_order=natural, chunks=2)
        assert pl.a2a_count(natural) == (5 if natural else 4)


def test_chunks_and_factors_numerics(run):
    inp, ranks, _ref = run
    spec = np.fft.fft(inp["x8192"].astype(np.complex128))
    for key in ("natK1", "natK2", "natK4", "nat_unpacked", "factors"):
        assert _rel(_joined(ranks, key), spec) < NP_TOL, key
    x = inp["x2048"].astype(np.complex128)
    n1, n2 = D.pencil_factors(2048, WORLD)
    assert n1 != n2
    assert _rel(_joined(ranks, "nonsquare"), np.fft.fft(x)) < NP_TOL
    assert np.abs(_joined(ranks, "nonsquare_rt") - x).max() < 5e-5 * np.abs(x).max()


def test_dtensor_wrappers(run):
    inp, ranks, _ref = run
    assert all(bool(r["dtensor_placement"]) for r in ranks)
    assert np.array_equal(_joined(ranks, "dtensor"), _joined(ranks, "nat_default"))
    x = inp["x8192"].astype(np.complex128)
    assert np.abs(_joined(ranks, "dtensor_rt") - x).max() < 5e-5 * np.abs(x).max()


def test_parseval_gradient(run):
    inp, ranks, _ref = run
    x = inp["xgrad"]
    np.testing.assert_allclose(_joined(ranks, "grad"), 2 * x.shape[-1] * x, rtol=1e-3, atol=1e-3)


def test_pconv_os_sharded(run):
    inp, ranks, _ref = run
    x, h = inp["conv_x"], inp["conv_h"]
    want = np.stack([np.convolve(r.astype(np.float64), h.astype(np.float64))[: x.shape[-1]] for r in x])
    local = O.fft_conv_os(torch.from_numpy(x), torch.from_numpy(h), block=CONV["block"], device="cpu").numpy()
    for r in ranks:  # the output is replicated: every rank holds all of it
        assert _rel(r["conv"], want) < 1e-4
        assert np.abs(r["conv"] - local).max() <= 1e-5 * np.abs(local).max()
    assert _counts(ranks, "conv") == {"all_to_all": 0, "all_gather": 1}


def test_injected_collective_fault_raises_on_every_rank(run):
    _inp, ranks, _ref = run
    assert [str(r["fault"]) for r in ranks] == ["CollectiveError"] * WORLD
