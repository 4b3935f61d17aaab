"""Each cell's control comes out not correct: the reference put in the
program's place at the next precision down (the stripmap at bfloat16
between stages, the LM with fp8 matrix products) fails the cell's limit,
at a size a test run holds, on three seeds.  On the chip the same readings
come from ``portbench/calibrate.py`` at the cells' own sizes, with the
LM's planted far-context fault."""

import pb_tiny
import pytest
import torch

from portbench import common, harness


@pytest.mark.parametrize("seed", [11, 2 ** 33 + 1, 987654321])
@pytest.mark.parametrize("cell", sorted(pb_tiny.TINY))
def test_control_fails_the_limit(cell, seed):
    resolved = common.cell(cell)
    ctx = harness.Context(cell=resolved, seed=seed, seconds=1.0, trace=False, device=torch.device("cpu"),
                          overrides=pb_tiny.TINY[cell])
    readings = common.load("drivers", resolved["workload"]["driver"]).control(ctx)
    limits = ctx.check_spec["limits"]
    assert any(max(readings[name]) > limit for name, limit in limits.items())


@pytest.mark.parametrize("seed", [11, 2 ** 33 + 1, 987654321])
def test_far_context_fault_fails_the_layer_limit(seed):
    """The reference with each attention layer's keys further back than half
    the prompt left out, in the program's place: every position's sub-layer
    outputs see it, where the last position's logits alone could not."""
    resolved = common.cell("danube_prefill")
    ctx = harness.Context(cell=resolved, seed=seed, seconds=1.0, trace=False, device=torch.device("cpu"),
                          overrides=pb_tiny.TINY["danube_prefill"])
    readings = common.load("drivers", "lm_prefill").control(ctx)
    assert max(readings["fault_layer_err"]) > ctx.check_spec["limits"]["layer_err"]
