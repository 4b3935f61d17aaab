"""The executor's last passes on the CPU: the digit-reversal ``reorder``
pass of a program of three or more factors and the pencil-order row pass,
held against the reference's ``execute_plan`` (Pallas interpret mode) and
``np.fft`` at 1e-3·max|ref|.

A small ``fused_max`` gives the planner three or four factors at a few
thousand points, the programs it emits past 2^32 at the default.  The
reorder is a torch copy and launches no kernel; every other pass is one
plain call here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import roofline as ref_rl
from repro.core import plan as ref_plan
from repro.kernels import ops as ref_ops
from repro_torch import kernels
from repro_torch.analysis import roofline as rl
from repro_torch.core import fft as F
from repro_torch.core import plan as plan_lib
from repro_torch.kernels import ops

TOL = 1e-3

#: (n, fused_max): three factors, four factors, three factors of 32, 16
#: and 64 points; TWO_FACTORS a program of two (256 × 128).
PROGRAMS = [(1 << 12, 16), (1 << 13, 16), (1 << 15, 64)]
TWO_FACTORS = (1 << 15, 256)


def _planes(shape, seed=0):
    rng = np.random.default_rng(seed + shape[-1])
    return rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32)


def _c(planes):
    return np.asarray(planes[0]).astype(np.float64) + 1j * np.asarray(planes[1]).astype(np.float64)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _records(passes):
    return [dataclasses.asdict(p) for p in passes]


def _run(xr, xi, fft_plan, **kw):
    yr, yi = ops.execute_plan(torch.from_numpy(xr), torch.from_numpy(xi), fft_plan, **kw)
    return yr.numpy(), yi.numpy()


@pytest.mark.parametrize("n,fused_max", PROGRAMS)
@pytest.mark.parametrize("inverse", [False, True])
def test_reorder_program_matches_reference(n, fused_max, inverse):
    fft_plan = plan_lib.plan_fft(n, fused_max)
    ref = ref_plan.plan_fft(n, fused_max)
    assert _records(fft_plan.passes) == _records(ref.passes)
    assert len(plan_lib.program_factors(n, fused_max)) >= 3 and fft_plan.passes[-1].kind == "reorder"
    xr, xi = _planes((2, 3, n))
    kernels.reset_counts()
    got = _c(_run(xr, xi, fft_plan, inverse=inverse))
    counts = kernels.counts()
    # One plain call per pass but the reorder, which is a copy.
    names = ops.plan_kernels(fft_plan)
    assert names[-1] == "reorder" and "reorder" not in names[:-1]
    for name in set(names[:-1]):
        assert counts[f"{name}_plain"] == names.count(name)
        assert counts[name] == 0
    want = _c(ref_ops.execute_plan(jnp.asarray(xr), jnp.asarray(xi), ref, inverse=inverse, interpret=True))
    x = _c((xr, xi))
    oracle = np.fft.ifft(x) if inverse else np.fft.fft(x)
    assert _rel(got, want) <= TOL
    assert _rel(got, oracle) <= TOL


@pytest.mark.parametrize("n,fused_max", PROGRAMS + [TWO_FACTORS])
@pytest.mark.parametrize("inverse", [False, True])
def test_pencil_order_matches_reference(n, fused_max, inverse):
    fft_plan = plan_lib.plan_fft(n, fused_max)
    pencil = ops.pencil_passes(fft_plan)
    ref_passes = ref_plan.compile_passes(n, fused_max, order="pencil")
    assert _records(pencil) == _records(ref_passes)
    assert all(p.kind != "reorder" and p.view_in == p.view_out for p in pencil)
    xr, xi = _planes((2, n), seed=1)
    kernels.reset_counts()
    got = _c(_run(xr, xi, fft_plan, inverse=inverse, order="pencil"))
    # The last pass is the pencil-order row pass: a whole-signal kernel
    # over the contiguous rows.
    last = ops.plan_kernels(plan_lib.FFTPlan(n, (), (), pencil))[-1]
    assert last in ("dft_matmul", "fft4step")
    assert kernels.counts()[f"{last}_plain"] == 1
    want = _c(ref_ops.execute_program(jnp.asarray(xr), jnp.asarray(xi), ref_passes, inverse=inverse,
                                      interpret=True))
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("n,fused_max", [TWO_FACTORS] + PROGRAMS)
def test_pencil_order_is_k1_major_permutation(n, fused_max):
    """The reference's test on the port: pencil[k0, k1, …] holds
    X[k0 + f0·k1 + f0·f1·k2 …], so reversing the factor axes recovers the
    natural order (for three or more factors, what the reorder pass does)."""
    fft_plan = plan_lib.plan_fft(n, fused_max)
    fs = plan_lib.program_factors(n, fused_max)
    xr, xi = _planes((1, n), seed=2)
    nat = _run(xr, xi, fft_plan)
    pen = _run(xr, xi, fft_plan, order="pencil")
    perm = (0,) + tuple(range(len(fs), 0, -1))
    for a, b in zip(pen, nat):
        a = a.reshape(1, *fs).transpose(perm).reshape(1, n)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())


@pytest.mark.parametrize("order", ["natural", "pencil"])
def test_compile_passes_past_2_32(order):
    """n = 2^33 plans (no LUT is built): the reference's program pass for
    pass, three factors with the reorder in natural order, none in pencil
    order, and the roofline charges the reorder one round trip."""
    n = 1 << 33
    passes = plan_lib.compile_passes(n, order=order)
    assert _records(passes) == _records(ref_plan.compile_passes(n, order=order))
    kinds = [p.kind for p in passes]
    assert kinds.count("reorder") == (1 if order == "natural" else 0)
    assert len([k for k in kinds if k != "reorder"]) == 3
    if order == "natural":
        assert _records(ops.pencil_passes(plan_lib.plan_fft(n))) == _records(
            ref_plan.compile_passes(n, order="pencil"))
        report, ref_report = rl.fft_pass_report(n), ref_rl.fft_pass_report(n)
        assert report["modeled_hbm_bytes"] == ref_report["modeled_hbm_bytes"]
        assert report["passes"][-1]["kind"] == "reorder"
        assert report["passes"][-1]["hbm_bytes"] == 2 * n * 2 * 4
        assert ops.plan_kernels(plan_lib.plan_fft(n)) == ("cols_pass", "cols_pass", "fft4step", "reorder")


def _planned(n, fused_max, kind="fft"):
    """A CPU plan of a program ``plan()`` gives only past 2^32: the same
    handle, its LUTs from ``ops.plan_luts``."""
    fft_plan = plan_lib.plan_fft(n, fused_max)
    cpu = torch.device("cpu")
    return F.PlannedFFT(F.FFTSpec(n, kind=kind), F.get_backend("torch"), fft_plan, cpu,
                        ops.plan_luts(fft_plan, kind == "ifft", cpu))


def test_planned_reorder_program_names_the_reorder():
    planned = _planned(1 << 12, 16)
    assert planned.kernels == ("cols_pass", "cols_pass", "dft_matmul", "reorder")
    text = planned.describe()
    assert "digit-reversal reorder" in text and "pass 3 reorder" in text
    assert planned.hbm_round_trips == 4
    x = torch.complex(*map(torch.from_numpy, _planes((2, 1 << 12), seed=3)))
    assert _rel(planned(x).numpy(), np.fft.fft(x.numpy().astype(np.complex128))) <= TOL


@pytest.mark.parametrize("n,fused_max", PROGRAMS[:2])
@pytest.mark.parametrize("kind", ["fft", "ifft"])
def test_vjp_through_reorder_program(n, fused_max, kind):
    """The autograd leaf over a program that ends in the reorder: the
    backward runs the same program the other way (its reorder included,
    whose adjoint is the inverse permutation), against jax.vjp."""
    planned = _planned(n, fused_max, kind)
    xr, xi = _planes((2, n), seed=4)
    gr, gi = _planes((2, n), seed=5)
    tr = torch.from_numpy(xr).requires_grad_()
    ti = torch.from_numpy(xi).requires_grad_()
    yr, yi = planned((tr, ti))
    (yr * torch.from_numpy(gr) + yi * torch.from_numpy(gi)).sum().backward()

    transform = jnp.fft.ifft if kind == "ifft" else jnp.fft.fft

    def planes_fn(a, b):
        y = transform(a + 1j * b)
        return jnp.real(y), jnp.imag(y)

    _, vjp = jax.vjp(planes_fn, jnp.asarray(xr), jnp.asarray(xi))
    want_r, want_i = vjp((jnp.asarray(gr), jnp.asarray(gi)))
    want = np.asarray(want_r) + 1j * np.asarray(want_i)
    assert _rel(tr.grad.numpy() + 1j * ti.grad.numpy(), want) <= TOL


@pytest.mark.parametrize("n", [16, 4096, 3000])
def test_ops_fft_ifft_match_reference(n):
    xr, xi = _planes((2, n), seed=6)
    got = ops.fft(torch.from_numpy(xr), torch.from_numpy(xi))
    want = ref_ops.fft(jnp.asarray(xr), jnp.asarray(xi), interpret=True)
    assert _rel(_c((got[0].numpy(), got[1].numpy())), _c(want)) <= TOL
    back = ops.ifft(*got)
    assert _rel(_c((back[0].numpy(), back[1].numpy())), _c((xr, xi))) <= TOL


def test_order_is_checked():
    xr, xi = _planes((1, 64), seed=7)
    with pytest.raises(F.PlanError, match="order must be"):
        _run(xr, xi, plan_lib.plan_fft(64), order="bogus")
    with pytest.raises(F.PlanError, match="natural order"):
        ops.execute_plan(torch.zeros(1, 8, 16), torch.zeros(1, 8, 16), plan_lib.plan_fft2(16, 8), order="pencil")
