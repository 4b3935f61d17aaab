"""Every pipeline on the CPU route at a tiny size: one request of each
input against the float64 reference, the bf16 control departing, and the
planted faults caught; the open questions' cells come as data alone."""

import random

import pb_tiny
import pytest
import torch

from portbench import common, compare

SAR = {**common.config("ers_stripmap"), **pb_tiny.SAR["config"]}
CASES = {
    "stripmap": (SAR, {}),
    "spotlight": (pb_tiny.SPOTLIGHT, {}),
    "batched_fft": (pb_tiny.BATCHED, {"resident": 2}),
}


def pipe(name, faults=()):
    cfg, traffic = CASES[name]
    return common.load("pipelines", name).Pipeline(cfg, traffic, torch.device("cpu"), 2 ** 35 + 1, faults=faults)


def readings(p, precision=None):
    for k in range(p.inputs):
        p.run(k)
    out = []
    for k in range(p.inputs):
        got = p.output(k) if precision is None else p.reference(k, precision)
        out.append(compare.rel_max(got, p.reference(k)))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_matches_its_reference(name):
    p = pipe(name)
    assert p.work > 0
    assert max(readings(p)) < 1e-5


@pytest.mark.parametrize("name", sorted(CASES))
def test_bfloat16_control_fails_the_limit(name):
    assert min(readings(pipe(name), "bfloat16")) > 1e-4


@pytest.mark.parametrize("fault", ["alter_answer", "skip_half"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_planted_fault_is_caught(name, fault):
    assert max(readings(pipe(name, faults=(fault,)))) > 1e-4


def test_check_samples_are_drawn_from_the_seed():
    a = random.Random(2 ** 40).sample(range(32), 8)
    assert a == random.Random(2 ** 40).sample(range(32), 8)
