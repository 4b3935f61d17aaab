"""The roofline model of the port (``repro_torch.analysis.roofline``) against
the reference's (``repro.analysis.roofline``).

Bytes and flops are the reference's account over the same pass programs,
so every count must be equal; only the seconds differ, since the port
divides by the H100's data-sheet rates where the reference divides by a
TPU v5e's.  Shapes and candidate lists are drawn from numpy with a seed.
"""

import math

import numpy as np
import pytest

from repro.analysis import roofline as ref_rl
from repro_torch.analysis import roofline as rl

#: Keys whose values divide by a device's rate: the one place the two
#: packages differ.
SECONDS = ("memory_s", "joint_memory_s", "fallback_memory_s")


def _counts(report):
    """The report without its seconds, nested dicts included."""
    if isinstance(report, dict):
        return {k: _counts(v) for k, v in report.items() if k not in SECONDS}
    if isinstance(report, list):
        return [_counts(v) for v in report]
    return report


def test_h100_row_is_the_data_sheet():
    assert rl.H100.peak_flops_f32 == 67e12 and rl.H100.hbm_bw == 3.35e12
    assert rl.H100.peak_flops_bf16 == 989e12 and rl.H100.hbm_bytes == 80e9


@pytest.mark.parametrize("n", [2**10, 2**16, 2**17, 2**22, 3000, 100003])
@pytest.mark.parametrize("batch", [1, 8])
def test_fft_pass_report_equals_reference(n, batch):
    got = rl.fft_pass_report(n, batch)
    want = ref_rl.fft_pass_report(n, batch)
    assert _counts(got) == _counts(want)
    assert got["memory_s"] == got["modeled_hbm_bytes"] / 3.35e12


@pytest.mark.parametrize("n,n2", [(64, 2**17), (4096, 8192), (3000, 4096)])
def test_fft_pass_report_2d_equals_reference(n, n2):
    got = rl.fft_pass_report(n, 2, n2=n2)
    assert _counts(got) == _counts(ref_rl.fft_pass_report(n, 2, n2=n2))
    assert got["n2"] == n2 and got["hbm_round_trips"] == len(got["passes"])


@pytest.mark.parametrize("n", [3000, 4999, 12288, 100003])
@pytest.mark.parametrize("doubled", [False, True])
def test_bluestein_report_equals_reference(n, doubled):
    from repro_torch.core.limits import bluestein_pad

    pad = 2 * bluestein_pad(n) if doubled else None
    got = rl.bluestein_report(n, batch=3, pad=pad)
    want = ref_rl.bluestein_report(n, batch=3, pad=pad)
    assert _counts(got) == _counts(want)
    assert got["pad"] == (pad or bluestein_pad(n))


def test_bluestein_report_refuses_powers_of_two():
    with pytest.raises(ValueError, match="power of two"):
        rl.bluestein_report(4096)


def _conv_grid():
    rng = np.random.default_rng(7)
    cases = [(1 << 20, 4097, 32, None), (65536, 1024, 1, None), (100, 1, 3, None), (40000, 129, 2, 512)]
    for _ in range(6):
        lh = int(rng.integers(2, 5000))
        cases.append((int(rng.integers(lh, 1 << 21)), lh, int(rng.integers(1, 9)), None))
    return cases


@pytest.mark.parametrize("L,Lh,batch,block", _conv_grid())
def test_conv_report_equals_reference(L, Lh, batch, block):
    got = rl.conv_report(L, Lh, batch=batch, block=block)
    want = ref_rl.conv_report(L, Lh, batch=batch, block=block)
    assert _counts(got) == _counts(want)
    assert math.isclose(got["overlap_save"]["memory_s"] * 3.35e12, got["overlap_save"]["hbm_bytes"])


@pytest.mark.parametrize("n,n2", [(2048, 2**17), (512, 2**18), (4096, 4096)])
def test_fft2_fallback_report_equals_reference(n, n2):
    got = rl.fft2_fallback_report(n, n2, batch=2)
    assert _counts(got) == _counts(ref_rl.fft2_fallback_report(n, n2, batch=2))


@pytest.mark.parametrize("seed", range(4))
def test_prune_candidates_keeps_the_reference_survivors(seed):
    rng = np.random.default_rng(seed)
    budget = 1 << 20
    cands = [
        ({"i": i}, int(rng.integers(1000, 1400)), int(rng.integers(0, 2 * budget)))
        for i in range(12)
    ]
    for vmem in (None, budget):
        got = rl.prune_candidates(cands, tol=0.2, vmem_budget=vmem)
        want = ref_rl.prune_candidates(cands, tol=0.2, vmem_budget=vmem)
        assert [c[0] for c in got] == [c[0] for c in want]
    # Nothing feasible: every candidate is kept for measurement, as in the
    # reference.
    assert rl.prune_candidates([({"i": 0}, 5, 10)], vmem_budget=1) == [({"i": 0}, 5, 10)]
