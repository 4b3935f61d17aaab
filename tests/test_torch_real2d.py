"""The real and 2-D kinds end to end on the CPU, and ``axis=-2``.

``plan(FFTSpec(...), device="cpu")`` against the reference's
``plan(..., backend="xla")`` and ``np.fft`` on the same seeded numpy inputs,
at the reference's own 1e-3·max|ref|; the pass program record for record
against the reference handle's; one plain call per pass; and the 2-D
executor against the reference's executor (Pallas interpret mode) on a
strip-mined program.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fft as ref_fft
from repro.core import plan as ref_plan
from repro.kernels import ops as ref_ops
from repro_torch import kernels
from repro_torch.core import fft as F
from repro_torch.core import plan as plan_lib
from repro_torch.kernels import ops

TOL = 1e-3


def _rng(*key):
    return np.random.default_rng(sum(key) + 7)


def _real(shape, seed=0):
    return _rng(seed, *shape).standard_normal(shape).astype(np.float32)


def _complex(shape, seed=0):
    rng = _rng(seed, *shape)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _c(planes):
    return np.asarray(planes[0], np.float64) + 1j * np.asarray(planes[1], np.float64)


def _np(y):
    if isinstance(y, tuple):
        return y[0].numpy().astype(np.float64) + 1j * y[1].numpy().astype(np.float64)
    return y.numpy()


def _rel(a, b):
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


def _records(passes):
    return [plan_lib.pass_record(p) for p in passes]


def _run(planned, x):
    """One planned call, held to one plain call per pass and no launch."""
    kernels.reset_counts()
    y = planned(x)
    counts = kernels.counts()
    plain = sum(v for k, v in counts.items() if k.endswith("_plain"))
    launched = sum(v for k, v in counts.items() if not k.endswith("_plain"))
    assert (plain, launched) == (len(planned.passes), 0), counts
    for name in set(planned.kernels):
        assert counts[f"{name}_plain"] == planned.kernels.count(name)
    return y


def _check_against_reference(spec, planned):
    ref = ref_fft.plan(ref_fft.FFTSpec(spec.n, kind=spec.kind, axis=spec.axis, n2=spec.n2),
                       backend="xla")
    assert _records(planned.passes) == _records(ref.passes)
    assert planned.hbm_round_trips == ref.hbm_round_trips == len(planned.passes)
    assert len(planned.kernels) == len(planned.passes)
    return ref


@pytest.mark.parametrize("n", [2, 16, 4096, 1 << 17])
def test_rfft_irfft(n):
    x = _real((3, n))
    spec = F.FFTSpec(n, kind="rfft")
    fwd = F.plan(spec, device="cpu")
    ref = _check_against_reference(spec, fwd)
    y = _run(fwd, torch.from_numpy(x))
    oracle = np.fft.rfft(x.astype(np.float64))
    assert y[0].shape == (3, n // 2 + 1)
    assert _rel(_np(y), oracle) <= TOL
    assert _rel(_np(y), _c(ref(jnp.asarray(x)))) <= TOL
    assert fwd.kernels[-1] == "rfft_recomb"

    ispec = F.FFTSpec(n, kind="irfft")
    inv = F.plan(ispec, device="cpu")
    iref = _check_against_reference(ispec, inv)
    z = _run(inv, y).numpy()
    assert z.shape == x.shape and z.dtype == np.float32
    assert _rel(z, x) <= TOL
    bins = (oracle.real.astype(np.float32), oracle.imag.astype(np.float32))
    assert _rel(inv(tuple(map(torch.from_numpy, bins))).numpy(), np.asarray(iref(bins))) <= TOL
    assert inv.kernels[0] == "irfft_recomb"


@pytest.mark.parametrize("n2,n", [(16, 64), (32, 2048), (1 << 17, 8)])
def test_fft2_ifft2(n2, n):
    x = _complex((2, n2, n))
    x128 = x.astype(np.complex128)
    for kind, oracle in (("fft2", np.fft.fft2(x128)), ("ifft2", np.fft.ifft2(x128))):
        spec = F.FFTSpec(n, kind=kind, n2=n2)
        planned = F.plan(spec, device="cpu")
        ref = _check_against_reference(spec, planned)
        y = _run(planned, torch.from_numpy(x))
        assert y.dtype == torch.complex64 and y.shape == x.shape
        assert _rel(_np(y), oracle) <= TOL
        assert _rel(_np(y), np.asarray(ref(jnp.asarray(x)))) <= TOL
    if n2 > plan_lib.FUSED_MAX:  # strip-mined columns: strided factor, then natural
        assert planned.kernels[-2:] == ("cols_pass", "cols_natural")


@pytest.mark.parametrize("n2,n", [(64, 128), (128, 2048)])
def test_rfft2_irfft2(n2, n):
    x = _real((2, n2, n))
    spec = F.FFTSpec(n, kind="rfft2", n2=n2)
    fwd = F.plan(spec, device="cpu")
    ref = _check_against_reference(spec, fwd)
    y = _run(fwd, torch.from_numpy(x))
    oracle = np.fft.rfft2(x.astype(np.float64))
    assert y[0].shape == (2, n2, n // 2 + 1)
    assert _rel(_np(y), oracle) <= TOL
    assert _rel(_np(y), _c(ref(jnp.asarray(x)))) <= TOL
    # Rows, recombination, then the column pass over the m + 1 bins.
    assert fwd.kernels[-2:] == ("rfft_recomb", "cols_pass")

    ispec = F.FFTSpec(n, kind="irfft2", n2=n2)
    inv = F.plan(ispec, device="cpu")
    _check_against_reference(ispec, inv)
    z = _run(inv, y).numpy()
    assert z.shape == x.shape
    assert _rel(z, x) <= TOL


@pytest.mark.parametrize("n,q,passes", [(4096, 5, 1), (1 << 17, 3, 2)])
@pytest.mark.parametrize("kind", ["fft", "ifft"])
def test_axis_minus_2(n, q, passes, kind):
    """One pass runs as one in-place column pass; two go through the
    reference's transpose sandwich.  Either way one call per pass."""
    x = _complex((2, n, q))
    spec = F.FFTSpec(n, kind=kind, axis=-2)
    planned = F.plan(spec, device="cpu")
    ref = _check_against_reference(spec, planned)
    assert len(planned.passes) == passes
    if passes == 1:
        assert planned.kernels == ("cols_pass",)
    y = _run(planned, torch.from_numpy(x))
    x128 = x.astype(np.complex128)
    oracle = np.fft.fft(x128, axis=-2) if kind == "fft" else np.fft.ifft(x128, axis=-2)
    assert _rel(_np(y), oracle) <= TOL
    assert _rel(_np(y), np.asarray(ref(jnp.asarray(x)))) <= TOL


def test_batch_dims_planes_and_wrappers():
    x = _real((2, 3, 16, 64))
    xt = torch.from_numpy(x)
    yr, yi = F.rfft2(xt)
    assert yr.shape == (2, 3, 16, 33)
    assert _rel(_np((yr, yi)), np.fft.rfft2(x.astype(np.float64))) <= TOL
    assert _rel(F.irfft2((yr, yi), 64, 16).numpy(), x) <= TOL
    # A complex tensor is accepted for the inverse's bins.
    assert _rel(F.irfft2(torch.complex(yr, yi), 64, 16).numpy(), x) <= TOL

    c = _complex((2, 3, 16, 64))
    pr, pi = F.fft2((torch.from_numpy(c.real.copy()), torch.from_numpy(c.imag.copy())))
    assert pr.dtype == torch.float32 and pr.shape == c.shape
    assert _rel(_np((pr, pi)), np.fft.fft2(c.astype(np.complex128))) <= TOL
    assert _rel(F.ifft2(F.fft2(torch.from_numpy(c))).numpy(), c) <= TOL

    r = F.rfft(xt, axis=-2)  # a real FFT down a non-last axis
    assert _rel(_np(r), np.fft.rfft(x.astype(np.float64), axis=-2)) <= TOL
    assert _rel(F.irfft(r, 16, axis=-2).numpy(), x) <= TOL
    y = F.fft(torch.from_numpy(c), axis=0)
    assert _rel(y.numpy(), np.fft.fft(c.astype(np.complex128), axis=0)) <= TOL
    y = F.fft(torch.from_numpy(c), axis=-2)
    assert _rel(y.numpy(), np.fft.fft(c.astype(np.complex128), axis=-2)) <= TOL


def test_children_are_interned_and_described():
    a = F.plan(F.FFTSpec(4096, kind="rfft2", n2=256), device="cpu")
    assert a is F.plan(F.FFTSpec(4096, kind="rfft2", n2=256), device="cpu")
    inner, cols = a.children
    assert inner is F.plan(F.FFTSpec(2048), device="cpu")
    assert cols is F.plan(F.FFTSpec(256, axis=-2), device="cpu")
    assert a.kernels == ("fft4step", "rfft_recomb", "cols_pass")
    text = a.describe()
    assert "epilogue pass: rfft_recomb n=4096" in text and "pass 2 cols_pass" in text
    assert a.luts[0].shape == (2049,)


def test_real_kinds_refuse_complex_signals():
    with pytest.raises(F.PlanError, match="real signal"):
        F.plan(F.FFTSpec(16, kind="rfft"), device="cpu")(torch.zeros(2, 16, dtype=torch.complex64))
    with pytest.raises(F.PlanError, match="bins"):
        F.plan(F.FFTSpec(16, kind="irfft"), device="cpu")((torch.zeros(2, 8), torch.zeros(2, 8)))


def test_execute_program2d_matches_the_reference_executor():
    """A strip-mined column program (a small fused_max makes n2 = 512 two
    column factors) through the reference's executor in interpret mode and
    through the port's: the same passes, the same result."""
    n, n2, fused_max = 16, 512, 64
    passes = plan_lib.compile_passes2d(n, n2, fused_max)
    ref_passes = ref_plan.compile_passes2d(n, n2, fused_max)
    assert _records(passes) == _records(ref_passes)
    assert [p.axis for p in passes] == [-1, -2, -2]
    assert [ops.pass_kernel(p) for p in passes] == ["dft_matmul", "cols_pass", "cols_natural"]
    x = _complex((2, n2, n))
    for inverse in (False, True):
        kernels.reset_counts()
        yr, yi = ops.execute_program2d(
            torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()), passes, inverse=inverse
        )
        assert sum(kernels.counts().values()) == len(passes)
        rr, ri = ref_ops.execute_program2d(
            jnp.asarray(x.real), jnp.asarray(x.imag), ref_passes, inverse=inverse, interpret=True
        )
        ref = _c((rr, ri))
        assert _rel(_np((yr, yi)), ref) <= 1e-5
        x128 = x.astype(np.complex128)
        assert _rel(_np((yr, yi)), np.fft.ifft2(x128) if inverse else np.fft.fft2(x128)) <= TOL
