"""The port's planner emits the reference's pass program, pass for pass.

The reference's passes cross into the port as plain records
(``plan.pass_record`` / ``plan.plan_from_records``) — the port itself never
imports ``repro``.
"""

import pytest
import torch

from repro.core import limits as ref_limits
from repro.core import plan as ref_plan
from repro_torch.core import limits, plan

POW2_LOGS = list(range(1, 27))  # n = 2 … 2**26
BLUESTEIN_NS = [3, 1000, 2029, 12288]
IMAGES = [(8, 4), (2048, 256), (1024, 131072), (100, 64), (4096, 4096)]


def _records(passes):
    return [plan.pass_record(p) for p in passes]


@pytest.mark.parametrize("lg", POW2_LOGS)
def test_plan_fft_pass_for_pass(lg):
    n = 1 << lg
    mine, ref = plan.plan_fft(n), ref_plan.plan_fft(n)
    assert _records(mine.passes) == _records(ref.passes)
    assert mine.levels == ref.levels
    assert _records(mine.leaf_passes) == _records(ref.leaf_passes)
    assert mine.hbm_round_trips == ref.hbm_round_trips
    assert plan.describe_program(mine, 3) == ref_plan.describe_program(ref, 3)


@pytest.mark.parametrize("lg", [1, 10, 11, 16, 17, 22, 32, 33, 34])
@pytest.mark.parametrize("order", ["natural", "pencil"])
def test_compile_passes_orders(lg, order):
    n = 1 << lg
    assert _records(plan.compile_passes(n, order=order)) == _records(
        ref_plan.compile_passes(n, order=order)
    )


@pytest.mark.parametrize("n", BLUESTEIN_NS)
def test_bluestein_programs(n):
    assert _records(plan.plan_fft(n).passes) == _records(ref_plan.plan_fft(n).passes)
    pad = 2 * limits.bluestein_pad(n)  # a tuner-style larger pad
    assert _records(plan.compile_bluestein(n, pad)) == _records(ref_plan.compile_bluestein(n, pad))


@pytest.mark.parametrize("n,n2", IMAGES)
def test_plan_fft2(n, n2):
    mine, ref = plan.plan_fft2(n, n2), ref_plan.plan_fft2(n, n2)
    assert _records(mine.passes) == _records(ref.passes)
    assert mine.n2 == ref.n2 == n2
    assert _records(mine.leaf_passes) == _records(ref.leaf_passes)


@pytest.mark.parametrize("lg", [4, 10, 11, 13, 14, 16, 17, 20, 26])
def test_models_match_at_the_port_budget(lg):
    """Byte models and tile picks agree, the GPU pick at the port's H100
    budget (232,448 B)."""
    budget = limits.memory_budget("NVIDIA H100 80GB HBM3")
    assert budget == 232448
    for mine, ref in zip(plan.plan_fft(1 << lg).passes, ref_plan.plan_fft(1 << lg).passes):
        for bt in (1, 4, 64):
            assert plan.gpu_smem_bytes(mine, bt) == ref_plan.gpu_smem_bytes(ref, bt)
            assert plan.vmem_bytes(mine, bt) == ref_plan.vmem_bytes(ref, bt)
        assert plan.pick_batch_tile_gpu(mine, budget) == ref_plan.pick_batch_tile_gpu(ref, budget)
        assert plan.pick_batch_tile(mine) == ref_plan.pick_batch_tile(ref)
        assert plan.pass_hbm_bytes(mine, 5) == ref_plan.pass_hbm_bytes(ref, 5)
        if mine.view_in[0] > 1:
            assert plan.pick_pass_chunk(mine) == ref_plan.pick_pass_chunk(ref)


@pytest.mark.parametrize("lg", [1, 10, 16, 18, 22, 26])
@pytest.mark.parametrize("form", ["dict", "tuple"])
def test_plan_from_records_rebuilds_the_plan(lg, form):
    n = 1 << lg
    recs = _records(ref_plan.plan_fft(n).passes)
    if form == "tuple":
        recs = [tuple(r.values()) for r in recs]
    assert plan.plan_from_records(recs) == plan.plan_fft(n)


def test_plan_from_records_bluestein_and_errors():
    recs = _records(ref_plan.plan_fft(1000).passes)
    assert plan.plan_from_records(recs).passes == plan.plan_fft(1000).passes
    with pytest.raises(plan.faults.PlanError):
        plan.plan_from_records([{"kind": "direct", "n": 4, "bogus": 1}])
    with pytest.raises(plan.faults.PlanError):
        plan.plan_from_records([])


def test_memory_budget_table():
    if not torch.cuda.is_available():
        # No card: the reference's CPU answer, not a guessed GPU figure.
        assert limits.memory_budget() == ref_limits.VMEM_BUDGET
    assert limits.memory_budget("cpu") == ref_limits.memory_budget("cpu")
    assert limits.memory_budget("TPU v5e") == ref_limits.memory_budget("TPU v5e")
    # The port's H100 figure is the per-block opt-in maximum, 1 KiB under
    # the reference's per-SM carveout.
    assert ref_limits.memory_budget("NVIDIA H100") - limits.memory_budget("NVIDIA H100") == 1024
    assert limits.memory_budget("NVIDIA A100-SXM4-80GB") == ref_limits.memory_budget("NVIDIA A100-SXM4-80GB")
    assert limits.memory_budget("Some NVIDIA GPU") == ref_limits.GPU_SMEM_DEFAULT
    for name in ("DIRECT_MAX", "FUSED_MAX", "OS_FACTOR", "VMEM_BUDGET", "BLUESTEIN_MIN"):
        assert getattr(limits, name) == getattr(ref_limits, name)
    for n in (1, 5, 1000, 4097):
        assert limits.bluestein_pad(n) == ref_limits.bluestein_pad(n)
        assert limits.next_fast_len(n) == ref_limits.next_fast_len(n)
