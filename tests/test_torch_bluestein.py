"""Any-length FFTs on the CPU: the Bluestein stages and the planned route.

Each stage's plain version against the reference's Pallas kernel in
interpret mode, on the reference's own LUTs (``repro.kernels.ops.
_bluestein_luts``), at 1e-5·max|ref| (same algorithm, float32 sums in
another order).  The planned calls ``plan(FFTSpec(...), device="cpu")``
against the reference's ``plan(..., backend="xla")`` and ``np.fft`` at the
reference's own 1e-3·max|ref| (forward) and 1e-3·max|x| (round trip), with
the pass program record for record against the reference handle's and one
plain call per pass.  Inputs come from ``np.random.default_rng``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fft as ref_fft
from repro.core import plan as ref_plan
from repro.kernels import bluestein as ref_bluestein
from repro.kernels import ops as ref_ops
from repro_torch import kernels
from repro_torch.core import fft as F
from repro_torch.core import fft_torch
from repro_torch.core import plan as plan_lib
from repro_torch.core import twiddle as tw
from repro_torch.core.faults import PlanError
from repro_torch.kernels import bluestein, ops

TOL = 1e-3
KERNEL_TOL = 1e-5


def _rng(*key):
    return np.random.default_rng(sum(key) + 13)


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


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _luts(ref_luts):
    """The reference's LUT planes as the port takes them: its (1, w) chirp
    and spectrum rows become (w,)."""
    return _t(*(a[0] if a.ndim == 2 and a.shape[0] == 1 else a for a in map(np.asarray, ref_luts)))


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


def _reference(spec, planned):
    ref = ref_fft.plan(ref_fft.FFTSpec(spec.n, kind=spec.kind, axis=spec.axis, n2=spec.n2),
                       backend="xla")
    assert _records(planned.passes) == _records(ref.passes)
    assert planned.hbm_round_trips == ref.hbm_round_trips == len(planned.passes)
    assert len(planned.kernels) == len(planned.passes)
    return ref


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _kernel_close(mine, ref):
    ref = [np.asarray(a) for a in ref]
    scale = max(np.abs(ref[0]).max(), np.abs(ref[1]).max())
    for a, b in zip(mine, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=KERNEL_TOL * scale)


def _counted(name, fn):
    kernels.reset_counts()
    out = fn()
    counts = kernels.counts()
    assert counts[f"{name}_plain"] == 1 and counts[name] == 0, counts
    return out


@pytest.mark.parametrize("n,inverse", [(97, False), (97, True), (1000, False), (1000, True)])
def test_fused_stages_match_pallas(n, inverse):
    """#7 / #8 at n = 97 (M = 256, direct inner in the reference) and
    n = 1000 (M = 2048, four-step inner), outer forward and inverse chirps:
    the port's radix stages on its own LUTs (the pad's roots table) against
    the Pallas kernels on the reference's (its DFT-matrix LUTs)."""
    fwd, inv = ref_plan.plan_fft(n).passes
    m = fwd.n1
    inner = ref_plan._leaf_pass(m)
    ref_kw = dict(n=n, m_pad=m, inner_kind=inner.kind, in1=inner.n1, in2=inner.n2)
    port_fwd, port_inv = plan_lib.plan_fft(n).passes
    b = 4
    x = _real((2, b, n), seed=n)
    ref = ref_bluestein.bluestein_fwd_call(*map(jnp.asarray, x), ref_ops._bluestein_luts(fwd, inverse),
                                           batch_tile=2, interpret=True, **ref_kw)
    luts = ops._bluestein_luts("cpu", port_fwd, inverse)
    mine = _counted("bluestein_fwd", lambda: bluestein.bluestein_fwd_call(*_t(*x), luts, n=n, m_pad=m))
    _kernel_close(mine, ref)
    assert tuple(mine[0].shape) == (b, m)

    y = _real((2, b, m), seed=m)
    ref = ref_bluestein.bluestein_inv_call(*map(jnp.asarray, y), ref_ops._bluestein_luts(inv, inverse),
                                           batch_tile=2, interpret=True, **ref_kw)
    luts = ops._bluestein_luts("cpu", port_inv, inverse)
    mine = _counted("bluestein_inv", lambda: bluestein.bluestein_inv_call(*_t(*y), luts, n=n, m_pad=m))
    _kernel_close(mine, ref)
    assert tuple(mine[0].shape) == (b, n)


@pytest.mark.parametrize("stage", ["pre", "mul", "post"])
def test_elem_stages_match_pallas(stage):
    """#9's three stages at n = 300, M = 1024."""
    n, m = 300, 1024
    p = ref_plan.Pass(kind="bluestein", n=n, n1=m, stage=stage)
    w_in = n if stage == "pre" else m
    x = _real((2, 4, w_in), seed=w_in)
    luts = ref_ops._bluestein_luts(p, False)
    ref = ref_bluestein.bluestein_elem_call(*map(jnp.asarray, x), luts, stage=stage, n=n,
                                            m_pad=m, batch_tile=2, interpret=True)
    mine = _counted("bluestein_elem", lambda: bluestein.bluestein_elem_call(
        *_t(*x), _luts(luts), stage=stage, n=n, m_pad=m))
    _kernel_close(mine, ref)


def test_port_luts_are_the_reference_tables():
    """``ops._bluestein_luts`` carries the reference's chirp, B̂ and
    post-chirp tables, as 1-D planes; a fused stage's inner planes are the
    pad's roots table, forward for ``fwd`` and inverse for ``inv``, where the
    reference carries the inner transform's DFT-matrix LUTs."""
    for p in ref_plan.plan_fft(300, fused_max=256).passes + ref_plan.plan_fft(1000).passes:
        if p.kind != "bluestein":
            continue
        for inverse in (False, True):
            mine = ops._bluestein_luts("cpu", p, inverse)
            ref = ref_ops._bluestein_luts(p, inverse)
            if p.stage == "fwd":
                mine, roots = mine[:2] + mine[4:], (mine[2:4], tw.roots(p.n1, False))
                ref = ref[:2] + ref[-2:]
            elif p.stage == "inv":
                mine, roots = mine[2:], (mine[:2], tw.roots(p.n1, True))
                ref = ref[-2:]
            else:
                roots = None
            assert len(mine) == len(ref)
            for a, b in zip(mine, ref):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b).reshape(a.shape))
            if roots is not None:
                for a, b in zip(*roots):
                    np.testing.assert_array_equal(a.numpy(), b)


def test_wrappers_validate_operands():
    x = _t(*_real((2, 3, 7)))
    luts = ops._bluestein_luts("cpu", plan_lib.plan_fft(7).passes[0], False)
    with pytest.raises(PlanError, match="power of two"):
        bluestein.bluestein_fwd_call(*x, luts, n=7, m_pad=12)
    with pytest.raises(PlanError, match="LUT"):
        bluestein.bluestein_fwd_call(*x, luts[:4], n=7, m_pad=16)
    with pytest.raises(PlanError, match="shape"):
        bluestein.bluestein_fwd_call(*x, luts, n=7, m_pad=32)
    with pytest.raises(PlanError, match="fused regime"):
        bluestein.bluestein_fwd_call(*x, luts, n=7, m_pad=1 << 17)
    with pytest.raises(PlanError, match="factor"):
        bluestein.bluestein_inv_call(*x, luts, n=7, m_pad=4096, in1=16)
    with pytest.raises(PlanError, match="stage"):
        bluestein.bluestein_elem_call(*x, luts[:2], stage="bogus", n=7, m_pad=16)


# ---------------------------------------------------------------------------
# the torch oracle and the planned route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,pad", [(3, None), (97, None), (1000, None), (1000, 4096), (12288, None)])
@pytest.mark.parametrize("inverse", [False, True])
def test_bluestein_fft_oracle(n, pad, inverse):
    x = _complex((2, n))
    yr, yi = fft_torch.bluestein_fft(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()),
                                     inverse=inverse, pad=pad)
    x128 = x.astype(np.complex128)
    want = np.fft.ifft(x128) if inverse else np.fft.fft(x128)
    assert _rel(_np((yr, yi)), want) <= TOL


@pytest.mark.parametrize("n", [1, 3, 6, 97, 1536, 2029])
@pytest.mark.parametrize("axis", [-1, -2])
def test_fft_ifft_any_length(n, axis):
    shape = (3, n) if axis == -1 else (2, n, 3)
    x = _complex(shape)
    x128 = x.astype(np.complex128)
    y = None
    for kind, oracle in (("fft", np.fft.fft(x128, axis=axis)), ("ifft", np.fft.ifft(x128, axis=axis))):
        spec = F.FFTSpec(n, kind=kind, axis=axis)
        planned = F.plan(spec, device="cpu")
        ref = _reference(spec, planned)
        out = _run(planned, torch.from_numpy(x))
        assert out.dtype == torch.complex64 and out.shape == x.shape
        assert _rel(_np(out), oracle) <= TOL
        assert _rel(_np(out), np.asarray(ref(jnp.asarray(x)))) <= TOL
        if kind == "fft":
            y = out
    if n > 2 and n & (n - 1):
        assert planned.kernels == ("bluestein_fwd", "bluestein_inv")
    back = F.plan(F.FFTSpec(n, kind="ifft", axis=axis), device="cpu")(y)
    assert _rel(_np(back), x) <= TOL


@pytest.mark.parametrize("n", [7, 251, 6, 96, 1000])
def test_rfft_irfft_any_length(n):
    """Odd n: one full-length complex Bluestein child, no recombination.
    Even non-power-of-two n: a Bluestein child of n/2 and the recombination."""
    x = _real((3, n))
    spec = F.FFTSpec(n, kind="rfft")
    fwd = F.plan(spec, device="cpu")
    ref = _reference(spec, fwd)
    y = _run(fwd, torch.from_numpy(x))
    oracle = np.fft.rfft(x.astype(np.float64))
    assert y[0].shape == (3, n // 2 + 1)
    assert _rel(_np(y), oracle) <= TOL
    assert _rel(_np(y), _c(ref(jnp.asarray(x)))) <= TOL
    odd = n % 2 == 1
    assert fwd.epilogue is None if odd else fwd.kernels[-1] == "rfft_recomb"
    assert (fwd.children[0].spec.n, "bluestein_fwd") == (n if odd else n // 2, fwd.kernels[0])

    ispec = F.FFTSpec(n, kind="irfft")
    inv = F.plan(ispec, device="cpu")
    iref = _reference(ispec, inv)
    z = _run(inv, y).numpy()
    assert z.shape == x.shape and z.dtype == np.float32
    assert _rel(z, x) <= TOL
    bins = (oracle.real.astype(np.float32), oracle.imag.astype(np.float32))
    assert _rel(inv(tuple(map(torch.from_numpy, bins))).numpy(), np.asarray(iref(bins))) <= TOL


@pytest.mark.parametrize("kind", ["fft2", "ifft2"])
def test_fft2_non_power_of_two_rows(kind):
    n2, n = 16, 97
    x = _complex((2, n2, n))
    x128 = x.astype(np.complex128)
    spec = F.FFTSpec(n, kind=kind, n2=n2)
    planned = F.plan(spec, device="cpu")
    ref = _reference(spec, planned)
    y = _run(planned, torch.from_numpy(x))
    oracle = np.fft.fft2(x128) if kind == "fft2" else np.fft.ifft2(x128)
    assert _rel(_np(y), oracle) <= TOL
    assert _rel(_np(y), np.asarray(ref(jnp.asarray(x)))) <= TOL
    assert planned.kernels == ("bluestein_fwd", "bluestein_inv", "cols_pass")
    back = F.plan(F.FFTSpec(n, kind="ifft2" if kind == "fft2" else "fft2", n2=n2), device="cpu")(y)
    assert _rel(_np(back), x) <= TOL


def test_fft2_strip_mined_columns_at_a_non_power_of_two_width():
    """(1, 2^17, 12): the strided column factor's twiddle serves runs of 12
    columns (``tw_every = 12``)."""
    n2, n = 1 << 17, 12
    x = _complex((1, n2, n))
    planned = F.plan(F.FFTSpec(n, kind="fft2", n2=n2), device="cpu")
    assert planned.kernels == ("bluestein_fwd", "bluestein_inv", "cols_pass", "cols_natural")
    y = _run(planned, torch.from_numpy(x))
    assert _rel(_np(y), np.fft.fft2(x.astype(np.complex128))) <= TOL


@pytest.mark.parametrize("inverse", [False, True])
def test_split_regime_through_the_executor(inverse):
    """n = 300 with fused_max = 256: M = 1024 runs as its own two-pass
    program, pre → cols/rows (forward) → mul → cols/rows (inverse) → post.
    The inverse case shows ``Pass.inverse`` honoured: the inner conv runs
    forward then inverse whatever the outer direction."""
    fft_plan = plan_lib.plan_fft(300, fused_max=256)
    assert _records(fft_plan.passes) == _records(ref_plan.plan_fft(300, fused_max=256).passes)
    assert ops.plan_kernels(fft_plan) == (
        "bluestein_elem", "cols_pass", "rows_natural", "bluestein_elem",
        "cols_pass", "rows_natural", "bluestein_elem")
    x = _complex((3, 300))
    kernels.reset_counts()
    yr, yi = ops.execute_plan(torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()),
                              fft_plan, inverse=inverse)
    assert kernels.counts()["bluestein_elem_plain"] == 3
    x128 = x.astype(np.complex128)
    assert _rel(_np((yr, yi)), np.fft.ifft(x128) if inverse else np.fft.fft(x128)) <= TOL
    luts = ops.plan_luts(fft_plan, inverse, "cpu")
    # The inner passes carry the forward then the inverse roots table.
    fwd_w = ops._roots_luts("cpu", 32, False)[0]
    inv_w = ops._roots_luts("cpu", 32, True)[0]
    assert sum(t is fwd_w for t in luts) == 2 and sum(t is inv_w for t in luts) == 2


def test_specs_follow_the_reference_rules():
    with pytest.raises(PlanError, match="power-of-two row length"):
        F.FFTSpec(100, kind="rfft2", n2=16)
    with pytest.raises(PlanError, match="power-of-two n2"):
        F.FFTSpec(100, kind="fft2", n2=12)
    with pytest.raises(NotImplementedError, match="bluestein pads beyond fused_max²"):
        F.plan(F.FFTSpec((1 << 31) + 1), device="cpu")
    planned = F.plan(F.FFTSpec(1000, kind="rfft"), device="cpu")
    assert planned is F.plan(F.FFTSpec(1000, kind="rfft"), device="cpu")
    assert planned.children[0] is F.plan(F.FFTSpec(500), device="cpu")
    text = planned.describe()
    assert "bluestein: n=500 pad 1024 (2.05x)" in text
    assert "pass 0 bluestein_fwd, pass 1 bluestein_inv, pass 2 rfft_recomb" in text
    assert "bluestein" not in F.plan(F.FFTSpec(1024), device="cpu").describe()
