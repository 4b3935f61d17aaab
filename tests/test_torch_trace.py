"""The trace cost analyzer (``repro_torch.analysis.trace``) and the kernels'
fake branch: the counterparts of the five tests of
``tests/test_hlo_analysis.py``, then what only the port has.

The reference parses compiled HLO and multiplies loop bodies by their trip
counts; the port runs the call on fake tensors and counts each op as it is
dispatched, so a Python loop of 8 matmuls counts 8 of them exactly and its
bytes grow linearly with its length.  ``roofline_terms`` is held against
the reference's on an ``HW`` with the reference's rates; an in-place slot
write moves its update, not its buffer.  Then: a planned
FFT on a fake tensor of the simulated card counts one launch per pass of
its plan and returns the right shape; a real CPU tensor never takes the
fake branch, and a meta or mixed launch raises; the plan, pencil-plan,
LUT and rope caches keep nothing a fake run made (their process-wide
entries do not change, and a real call afterwards reads real tensors);
one microbatch traced and scaled by two, plus the step's end, equals the
trace of the whole two-microbatch step.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.analysis import roofline as ref_rl
from repro_torch import kernels
from repro_torch.analysis import roofline as rl
from repro_torch.analysis.trace import analyze, kernel_cost, trace
from repro_torch.configs.base import TrainConfig, get_config
from repro_torch.configs.reduce import make_reduced
from repro_torch.core import fake
from repro_torch.core import fft as fft_lib
from repro_torch.core import distributed as dist_lib
from repro_torch.core.faults import PlanError
from repro_torch.kernels import dft_matmul, ops
from repro_torch.models.layers import rope


def _fake(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device=fake.card())


def test_loop_flops_counted_per_iteration():
    with FakeTensorMode():
        w, x0 = _fake(8, 256, 256), _fake(4, 256)

        def unrolled(x, w):
            for i in range(8):
                x = torch.tanh(x @ w[i])
            return x

        c = analyze(unrolled, x0, w)
    assert c.dot_flops == 8 * 2 * 4 * 256 * 256
    assert c.dot_flops_by_dtype == {"float32": c.dot_flops}
    assert c.flops == c.dot_flops + 8 * 4 * 256  # and one per tanh output element
    assert c.unknown_trip_loops == 0


def test_dot_flops_with_batch_dims():
    with FakeTensorMode():
        c = analyze(torch.matmul, _fake(4, 32, 64), _fake(4, 64, 16))
        e = analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b), _fake(4, 32, 64, dtype=torch.bfloat16),
                    _fake(4, 64, 16, dtype=torch.bfloat16))
    assert c.dot_flops == 2 * 4 * 32 * 64 * 16
    assert e.dot_flops_by_dtype == {"bfloat16": 2 * 4 * 32 * 64 * 16}


def test_loop_bytes_grow_linearly():
    """Each step reads its row and writes its product: no step counts the
    whole buffer, and twice the steps move twice the bytes."""

    def f(xs):
        return [x * 2.0 for x in xs]

    with FakeTensorMode():
        c64 = analyze(f, _fake(64, 128))
        c128 = analyze(f, _fake(128, 128))
    total = 64 * 128 * 4
    assert c64.bytes == 2 * total  # every row read once and written once
    assert c128.bytes == 2 * c64.bytes


def test_inplace_write_moves_the_update():
    """A decode step's slot write into a KV buffer moves the update (read
    and written) and its indices, not the buffer, as the reference counts
    a ``dynamic-update-slice``; an out-of-place write copies the buffer."""

    def write(buf, rows, at, new):
        buf[rows, at] = new
        return buf

    with FakeTensorMode():
        buf, new = _fake(4, 4096, 8, 64), _fake(4, 8, 64)
        rows = torch.zeros(4, dtype=torch.long, device=fake.card())
        c = analyze(write, buf, rows, rows, new)
        d = analyze(lambda b, r, a, v: b.index_put((r, a), v), buf, rows, rows, new)
    assert c.bytes == 2 * 4 * 8 * 64 * 4 + 2 * 4 * 8
    assert d.bytes >= 2 * buf.numel() * 4


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_roofline_terms_equal_reference(dtype):
    v5e = ref_rl.V5E
    hw = rl.HW(name="v5e", peak_flops_bf16=v5e.peak_flops_bf16, peak_flops_f32=v5e.peak_flops_f32,
               hbm_bw=v5e.hbm_bw, link_bw=v5e.link_bw, hbm_bytes=v5e.hbm_bytes)
    rng = np.random.default_rng(0)
    for flops, nbytes, coll in [(197e12, 0.0, 0.0), (0.0, 819e9, 0.0), (0.0, 0.0, 50e9),
                                *rng.uniform(0, 1e13, (5, 3)).tolist()]:
        assert rl.roofline_terms(flops, nbytes, coll, hw=hw, dtype=dtype) == ref_rl.roofline_terms(
            flops, nbytes, coll, dtype=dtype)
    # a {dtype: flops} mapping charges each part at its own peak
    t = rl.roofline_terms({"bfloat16": rl.H100.peak_flops_bf16, "float32": rl.H100.peak_flops_f32}, 0.0, 0.0)
    assert t["bound"] == "compute" and abs(t["compute_s"] - 2.0) < 1e-12
    assert rl.model_flops(10, 7) == 420.0


def test_elementwise_counted():
    with FakeTensorMode():
        c = analyze(lambda x: torch.tanh(x) + 1.0, _fake(1024))
    assert c.flops == 2 * 1024 and c.dot_flops == 0


@pytest.mark.parametrize("n", [256, 4096, 2**20, 3000])
def test_planned_fft_on_fake_tensors(n):
    before, traced = kernels.counts(), dict(fake.LAUNCHES)
    with FakeTensorMode():
        planned = fft_lib.plan(fft_lib.FFTSpec(n=n))
        xr = _fake(3, n)
        (yr, yi), c = trace(lambda a, b: planned((a, b)), xr, torch.zeros_like(xr))
        names = ops.plan_kernels(planned.fft_plan)
    assert planned.backend.name == "cuda"  # the card's plan, not the CPU route
    assert isinstance(yr, FakeTensor) and tuple(yr.shape) == tuple(yi.shape) == (3, n)
    assert sum(c.launches.values()) == len(planned.fft_plan.passes)
    assert c.launches == {k: float(names.count(k)) for k in set(names)}
    assert kernels.counts() == before  # no real launch, no plain call
    after = fake.LAUNCHES
    assert {k: after[k] - traced.get(k, 0) for k in after if after[k] != traced.get(k, 0)} == {
        k: names.count(k) for k in names}
    # each pass reads and writes both planes of the 3 rows, and its LUTs
    assert c.kernel_bytes >= len(planned.fft_plan.passes) * 2 * 2 * 4 * 3 * n and c.kernel_flops > 0
    assert c.peak_memory_bytes >= 2 * 2 * 4 * 3 * n  # the planes in and out


def test_real_tensors_never_take_the_fake_branch():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, generator=gen), torch.randn(2, 64, generator=gen)
    rr, ri = (torch.from_numpy(a) for a in ops.tw.roots(64, False))
    before = dict(dft_matmul.COUNTS)
    y = dft_matmul.dft_matmul_call(*x, rr, ri)
    assert dft_matmul.COUNTS["dft_matmul_plain"] == before["dft_matmul_plain"] + 1
    assert dft_matmul.COUNTS["dft_matmul"] == before["dft_matmul"]
    ref = np.fft.fft(x[0].numpy() + 1j * x[1].numpy())
    np.testing.assert_allclose(y[0].numpy() + 1j * y[1].numpy(), ref, atol=1e-4)
    assert not fake.launch("dft_matmul", (*x, rr, ri), y)
    meta = [t.to("meta") for t in (*x, rr, ri)]
    with pytest.raises(PlanError, match="cuda or cpu"):
        dft_matmul.dft_matmul_call(*meta)
    with FakeTensorMode():
        mixed = (_fake(2, 64), _fake(2, 64))
        with pytest.raises(PlanError, match="fake and real"):
            fake.launch("dft_matmul", (*mixed, rr, ri), mixed)


def test_caches_keep_no_fake_tensor():
    caches = [fft_lib._plan_cached, dist_lib._pencil_plan_cached, ops._roots_luts, ops.recomb_luts,
              ops._pass_twiddle_luts, rope._freqs_on]
    spec = fft_lib.FFTSpec(n=2048, kind="rfft")
    real = fft_lib.plan(spec, device="cpu")  # a process-wide entry before the fake run
    before = [c.cache_info() for c in caches]
    with FakeTensorMode():
        x = _fake(2, 2048)
        faked = fft_lib.plan(spec)
        faked(x)
        rope.apply_rope(_fake(1, 4, 2, 8), torch.zeros(1, 4, dtype=torch.long, device=fake.card()), 1e4)
        dist_lib.plan_pencil(2**14, 4)
        assert all(isinstance(t, FakeTensor) for t in faked.luts)
    assert [c.cache_info() for c in caches] == before  # nothing reached the process-wide caches
    again = fft_lib.plan(spec, device="cpu")
    assert again is real and not any(isinstance(t, FakeTensor) for t in again.luts)
    sig = torch.randn(2, 2048, generator=torch.Generator().manual_seed(1))
    yr, yi = again(sig)
    assert not isinstance(yr, FakeTensor)
    np.testing.assert_allclose(yr.numpy() + 1j * yi.numpy(), np.fft.rfft(sig.numpy()), atol=1e-3)


def test_microbatches_scaled_equal_every_microbatch():
    """One microbatch traced and scaled by two, plus the step's end, is the
    trace of the whole two-microbatch step."""
    from repro_torch.models.model import DecoderLM
    from repro_torch.train.optimizer import make_optimizer
    from repro_torch.train.train_loop import TrainState, make_train_step

    cfg = make_reduced(dataclasses.replace(get_config("h2o-danube-1.8b"), use_spectral_mixer=True,
                                           compute_dtype="float32"))
    tc = TrainConfig(microbatches=2)
    step = make_train_step(cfg, tc)
    with FakeTensorMode():
        model = DecoderLM(cfg, device="meta")
        for mod in model.modules():
            for k, p in list(mod._parameters.items()):
                mod._parameters[k] = torch.nn.Parameter(_fake(*p.shape, dtype=p.dtype))
        state = TrainState(0, model, make_optimizer(tc)[0](model), {})
        batch = {k: _fake(4, 64, dtype=torch.long) for k in ("tokens", "targets")}
        whole = trace(step, state, batch)[1]
        part = step.micro(model, batch)[0]
        metrics, one = trace(step.accumulate, model, part, step.begin(model))
        scaled = one.scaled(2)
        scaled.add(trace(lambda: step.finish(state, step.begin(model), metrics))[1])
    assert whole.launches and whole.dot_flops > 0
    for f in ("flops", "bytes", "dot_flops", "collective_bytes", "kernel_bytes", "kernel_flops"):
        assert getattr(scaled, f) == getattr(whole, f), f
    assert scaled.launches == whole.launches and scaled.dot_flops_by_dtype == whole.dot_flops_by_dtype


def test_kernel_cost_counts_as_the_bound():
    """Bytes: every input plane and LUT once, every output once; flops
    5·f·log2 f per transform (and 6 per twiddle)."""
    with FakeTensorMode():
        x, r = _fake(4, 1024), _fake(1024)
        nbytes, flops = kernel_cost("dft_matmul", [x, x, r, r], [x, x], {"twiddle": False})
        assert nbytes == 4 * (4 * 4 * 1024 + 2 * 1024) and flops == 4 * 5 * 1024 * 10
        cols = _fake(2, 64, 32)
        _, flops = kernel_cost("cols_pass", [cols, cols, _fake(64), _fake(64), _fake(64, 32), _fake(64, 32)],
                               [cols, cols], {"twiddle": True})
        assert flops == 2 * 32 * 5 * 64 * 6 + 6 * 2 * 64 * 32
