"""The slice end to end on the CPU: ``plan(FFTSpec(n), device="cpu")``.

The same seeded numpy inputs go through the port's plain route and through
the reference's ``plan(..., backend="pallas")`` (Pallas interpret mode), and
both are held to ``np.fft`` at the reference's own 1e-3·max|ref|.
"""

import dataclasses
import os
import re
import stat

import numpy as np
import pytest
import torch

from repro.core import fft as ref_fft
from repro.core import plan as ref_plan
from repro_torch import kernels
from repro_torch.core import faults
from repro_torch.core import fft as F
from repro_torch.core import plan as plan_lib
from repro_torch.kernels import build, ref

SIZES = [2, 16, 1024, 2048, 65536, 1 << 17, 1 << 18, 1 << 20]
TOL = 1e-3


def _signal(n, batch=2, seed=0):
    rng = np.random.default_rng(seed + n)
    return (rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))).astype(np.complex64)


def _rel(a, b):
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["fft", "ifft"])
def test_planned_call_matches_reference_and_numpy(n, kind):
    x = _signal(n)
    planned = F.plan(F.FFTSpec(n, kind=kind), device="cpu")
    assert planned.backend.name == "torch" and planned.device.type == "cpu"
    kernels.reset_counts()
    y = planned(torch.from_numpy(x)).numpy()
    counts = kernels.counts()
    # One plain call per pass, and no kernel launch.
    for name in ("dft_matmul", "fft4step", "cols_pass", "rows_natural"):
        assert counts[f"{name}_plain"] == planned.kernels.count(name)
        assert counts[name] == 0
    assert len(planned.kernels) == len(planned.passes) == (1 if n <= 65536 else 2)

    oracle = np.fft.fft(x.astype(np.complex128)) if kind == "fft" else np.fft.ifft(x.astype(np.complex128))
    ref = np.asarray(ref_fft.plan(ref_fft.FFTSpec(n, kind=kind), backend="pallas")(x))
    assert y.dtype == np.complex64 and y.shape == x.shape
    assert _rel(y, oracle) <= TOL
    assert _rel(y, ref) <= TOL
    assert _rel(ref, oracle) <= TOL


def test_planes_in_planes_out_and_batch_dims():
    n = 4096
    x = _signal(n, batch=6).reshape(2, 3, n)
    planned = F.plan(F.FFTSpec(n), device="cpu")
    yr, yi = planned((torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())))
    assert yr.shape == (2, 3, n) and yr.dtype == torch.float32
    assert _rel(yr.numpy() + 1j * yi.numpy(), np.fft.fft(x.astype(np.complex128))) <= TOL
    # Host arrays are accepted and land on the plan's device.
    assert _rel(planned(x).numpy(), np.fft.fft(x.astype(np.complex128))) <= TOL
    # The convenience wrappers run on the input's device.
    z = F.ifft(F.fft(torch.from_numpy(x)))
    assert _rel(z.numpy(), x) <= TOL


def test_plans_are_interned_and_describe_their_kernels():
    a = F.plan(F.FFTSpec(1 << 20), device="cpu")
    assert a is F.plan(F.FFTSpec(1 << 20), device="cpu")
    assert a.kernels == ("cols_pass", "rows_natural")
    text = a.describe()
    assert "2 HBM round trip" in text and "pass 0 cols_pass" in text and "pass 1 rows_natural" in text


def _programs(lib, spec):
    """The pass programs a plan of ``spec`` holds, through the planner
    ``lib`` alone (the reference's or the port's ``core.plan``): no LUT is
    built, so a spec past 2^32 plans here in microseconds."""
    kind, n, n2 = spec.kind, spec.n, spec.n2
    if kind in ("fft", "ifft"):
        programs = [lib.plan_fft(n)]
    elif kind in ("fft2", "ifft2"):
        joint = lib.joint2d_supported(n2)
        programs = [lib.plan_fft2(n, n2)] if joint else [lib.plan_fft(n), lib.plan_fft(n2)]
    elif kind in ("rfft", "irfft"):
        programs = [lib.plan_fft(n if n % 2 else n // 2)]
    else:
        programs = [lib.plan_fft(n // 2), lib.plan_fft(n2)]
    return [[dataclasses.asdict(p) for p in prog.passes] for prog in programs]


@pytest.mark.parametrize(
    "spec",
    [
        # Non-power-of-two lengths whose Bluestein pad passes 2^32 (here
        # and at (1 << 31) + 1 below): the reference raises, and so does
        # the port.
        F.FFTSpec((1 << 32) + 1, kind="rfft"),
        F.FFTSpec((1 << 32) + 1, kind="irfft"),
        F.FFTSpec((1 << 31) + 1, kind="fft2", n2=8),
        # Powers of two past 2^32: three factors and the reorder pass.
        F.FFTSpec(16, kind="irfft2", n2=1 << 33),
        F.FFTSpec(1 << 34, kind="rfft"),
        F.FFTSpec((1 << 31) + 1),  # a pad of 2^33: raises
        F.FFTSpec(1 << 33),
        F.FFTSpec((1 << 31) + 1, axis=-2),  # a pad of 2^33: raises
    ],
)
def test_unported_specs_raise(spec):
    """Past 2^32 the port raises exactly where the reference does (a
    Bluestein pad past fused_max², the reference's words); elsewhere its
    spec check accepts the spec and its planner emits the reference's
    programs, pass for pass."""
    ref_spec = ref_fft.FFTSpec(spec.n, kind=spec.kind, axis=spec.axis, n2=spec.n2)
    try:
        want = _programs(ref_plan, ref_spec)
    except NotImplementedError as err:
        words = re.escape(str(err))
        with pytest.raises(NotImplementedError, match=words):
            _programs(plan_lib, spec)
        with pytest.raises(NotImplementedError, match=words):
            F.plan(spec, device="cpu")
        return
    F._check_slice(spec)
    got = _programs(plan_lib, spec)
    assert got == want
    assert any(p["kind"] == "reorder" for prog in got for p in prog)


def test_numerics_guards_and_tuning_raise():
    planned = F.plan(F.FFTSpec(16, kind="rfft"), device="cpu")
    with pytest.raises(faults.PlanError, match="check"):
        planned(torch.zeros(2, 16), check="bogus")
    with pytest.raises(faults.PlanError, match="complex kinds"):
        planned(torch.zeros(2, 16), check="parseval")
    # Every tune mode plans; the CPU route is untuned (the reference's xla
    # backend), so each mode runs the heuristic program, interned per mode.
    with pytest.raises(faults.PlanError, match="tune must be"):
        F.plan(F.FFTSpec(16), device="cpu", tune="fastest")
    measured = F.plan(F.FFTSpec(16), device="cpu", tune="measure")
    off = F.plan(F.FFTSpec(16), device="cpu", tune="off")
    assert measured is F.plan(F.FFTSpec(16), device="cpu", tune="measure")
    assert measured.tuned is None and off.tuned is None
    assert measured.passes == off.passes
    x = torch.randn(3, 16, dtype=torch.complex64)
    assert torch.equal(measured(x), off(x))


def test_plan_without_a_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(faults.PlanError, match="no CUDA device"):
        F.plan(F.FFTSpec(1024))
    with pytest.raises(faults.PlanError, match="no CUDA device"):
        F.plan(F.FFTSpec(1024), device="cuda")


def test_inputs_on_another_device_are_refused():
    planned = F.plan(F.FFTSpec(16), device="cpu")
    with pytest.raises(faults.PlanError):
        planned(torch.zeros(2, 16, device="meta"))


def test_injected_launch_fault_raises_without_fallback():
    planned = F.plan(F.FFTSpec(1 << 17), device="cpu")
    x = torch.from_numpy(_signal(1 << 17))
    kernels.reset_counts()
    with faults.inject_fault("kernel.launch", times=1):
        with pytest.raises(faults.KernelError):
            planned(x)
    assert sum(kernels.counts().values()) == 0  # nothing ran in its place
    assert planned(x).shape == x.shape  # the fault was spent; the plan works


def test_build_command_targets_sm90a(tmp_path):
    compiles, link, lib = build.compile_commands("nvcc", tmp_path)
    cus = sorted(p.name for p in build.csrc_dir().glob("*.cu"))
    assert sorted(os.path.basename(c[c.index("-c") + 1]) for c in compiles) == cus
    for cmd in compiles + [link]:
        assert cmd[0] == "nvcc"
        assert "arch=compute_90a,code=sm_90a" in cmd
    for cmd in compiles:
        assert {"-std=c++17", "-O3", "-fPIC"} <= set(cmd)
    assert "-shared" in link and link[-1] == str(lib)
    assert build.source_digest() in lib.name


def test_build_raises_clearly_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(faults.KernelError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(faults.KernelError, match="nvcc not found"):
        build.build()
    # An nvcc on CUDA_HOME is found first.
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    fake.write_text("#!/bin/sh\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    assert build.find_nvcc() == str(fake)
    with pytest.raises(faults.KernelError, match="nvcc failed"):
        build.build()


@pytest.mark.parametrize("n", [1, 8, 1024, 4096, 1 << 17])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_torch_oracle_matches_reference_math(n, inverse):
    """``core/fft_torch.py`` — the oracle of the plain versions — against the
    reference's traced four-step and ``np.fft``."""
    import jax.numpy as jnp

    from repro.core import fft_xla
    from repro_torch.core import fft_torch

    x = _signal(n, batch=2, seed=3)
    yr, yi = fft_torch.four_step_fft(
        torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()), inverse=inverse
    )
    y = yr.numpy() + 1j * yi.numpy()
    rr, ri = fft_xla.four_step_fft(jnp.asarray(x.real), jnp.asarray(x.imag), inverse=inverse)
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    x128 = x.astype(np.complex128)
    oracle = np.fft.ifft(x128) if inverse else np.fft.fft(x128)
    assert _rel(y, oracle) <= TOL
    assert _rel(y, ref) <= TOL
    if n <= 65536:
        # The plain pass program agrees with the oracle too.
        planned = F.plan(F.FFTSpec(n, kind="ifft" if inverse else "fft"), device="cpu")
        assert _rel(planned(torch.from_numpy(x)).numpy(), y) <= TOL


def test_backend_registry():
    assert F.available_backends() == ("cuda", "torch")
    with pytest.raises(faults.PlanError, match="already registered"):
        F.register_backend("torch", lambda *a, **k: None, {"cpu"})


#: Every kind at a power-of-two length, a Bluestein length and a two-pass
#: length, the 2-D kinds, and the column axis.
EMPTY = [F.FFTSpec(n, kind=k) for n in (1024, 1000, 1 << 20) for k in ("fft", "ifft", "rfft", "irfft")]
EMPTY += [F.FFTSpec(64, kind=k, n2=16) for k in ("fft2", "ifft2", "rfft2", "irfft2")]
EMPTY += [F.FFTSpec(1000, kind="fft2", n2=16), F.FFTSpec(1000, axis=-2), F.FFTSpec(1024, axis=-2)]


def empty_input(spec) -> np.ndarray:
    """A batch of 0 signals (images) of ``spec``'s input."""
    n = spec.n // 2 + 1 if spec.kind.startswith("irfft") else spec.n
    shape = (0, spec.n2, n) if spec.n2 else (0, n, 3) if spec.axis == -2 else (0, n)
    dtype = np.float32 if spec.kind.startswith("rfft") else np.complex64
    return np.zeros(shape, dtype)


@pytest.mark.parametrize("spec", EMPTY, ids=str)
def test_empty_batch(spec):
    """A batch of 0 gives what np.fft gives (its shape, the port's dtype),
    one plain call per pass and no launch."""
    x = empty_input(spec)
    planned = F.plan(spec, device="cpu")
    kernels.reset_counts()
    y = planned(torch.from_numpy(x))
    y = torch.complex(*y) if isinstance(y, tuple) else y
    counts = kernels.counts()
    assert tuple(y.shape) == ref.np_fft(spec, x).shape
    assert y.dtype == (torch.float32 if spec.kind.startswith("irfft") else torch.complex64)
    assert sum(v for k, v in counts.items() if k.endswith("_plain")) == len(planned.passes)
    assert sum(v for k, v in counts.items() if not k.endswith("_plain")) == 0


# ---------------------------------------------------------------------------
# numerics guards (the reference's tests/test_faults.py, on the CPU route)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fft", "rfft", "fft2"])
def test_check_nan_guard(kind):
    spec = F.FFTSpec(64, kind=kind, n2=8 if kind == "fft2" else None)
    planned = F.plan(spec, device="cpu")
    shape = (1, 8, 64) if kind == "fft2" else (1, 64)
    good = torch.ones(shape, dtype=torch.float32 if kind == "rfft" else torch.complex64)
    planned(good, check="nan")  # clean input passes
    bad = good.clone()
    bad[0, 3] = float("nan")
    with pytest.raises(faults.NumericsError):
        planned(bad, check="nan")


@pytest.mark.parametrize("kind,n", [("fft", 128), ("ifft", 128), ("fft", 100)])
def test_check_parseval_guard(kind, n):
    planned = F.plan(F.FFTSpec(n, kind=kind), device="cpu")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32)) + 0j
    planned(x, check="parseval")  # a correct transform conserves energy
    planned((x.real.contiguous(), x.imag.contiguous()), check="parseval")  # planes too
    with pytest.raises(faults.PlanError, match="check"):
        planned(x, check="bogus")
    # A corrupted result trips the guard.
    with pytest.raises(faults.NumericsError, match="Parseval"):
        planned._run_check(x, 1.1 * planned(x), "parseval")


def test_check_parseval_matches_reference():
    x = np.random.default_rng(5).standard_normal((2, 8, 16)).astype(np.complex64)
    for kind in ("fft2", "ifft2"):
        spec = F.FFTSpec(16, kind=kind, n2=8)
        F.plan(spec, device="cpu")(torch.from_numpy(x), check="parseval")
        ref_fft.plan(ref_fft.FFTSpec(16, kind=kind, n2=8), backend="xla")(x, check="parseval")
