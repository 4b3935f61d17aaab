"""The general generator: the prefill cell's schedule is the same work for
every seed, offers its rate exactly, and holds the law its file states."""

import math
import statistics

import pb_tiny  # noqa: F401
import pytest
import torch

from portbench import common, traffic

TRAFFIC = common.workload("danube_prefill")["traffic"]
SEEDS = [7, 2 ** 31 + 5, 2 ** 40 + 11]


def test_every_seed_gets_the_same_lengths_and_arrivals():
    lengths = {tuple(traffic.prompt_lengths(TRAFFIC, s)) for s in SEEDS}
    gaps = {tuple(traffic.gaps(TRAFFIC, s)) for s in SEEDS}
    assert len(lengths) == 1 and len(gaps) == 1


def test_token_ids_follow_the_seed():
    a, b = (traffic.prompts({**TRAFFIC, "prompt_min": 4, "prompt_max": 9, "distinct": 3}, s, 100, "cpu")
            for s in SEEDS[:2])
    assert [p.shape for p in a] == [p.shape for p in b]
    assert not all(torch.equal(x, y) for x, y in zip(a, b))


def test_a_cycle_offers_the_rate_exactly():
    g = traffic.gaps(TRAFFIC, 1)
    assert len(g) == TRAFFIC["distinct"]
    assert sum(g) == pytest.approx(TRAFFIC["distinct"] / TRAFFIC["rate_per_s"], rel=2e-2)
    assert traffic.arrival(g, 0) == 0.0
    assert traffic.arrival(g, len(g) + 2) == pytest.approx(sum(g) + g[0] + g[1])


def test_lengths_are_log_uniform_with_the_traces_median():
    lengths = sorted(traffic.prompt_lengths(TRAFFIC, 3))
    assert lengths[0] == TRAFFIC["prompt_min"] and lengths[-1] == TRAFFIC["prompt_max"]
    assert statistics.median(lengths) == pytest.approx(1500, rel=0.05)
    logs = [math.log(x) for x in lengths]
    steps = [b - a for a, b in zip(logs, logs[1:])]
    assert max(steps) - min(steps) < 1e-2


def test_linear_grid_keeps_both_ends():
    assert traffic.grid(1024, 4096, 4) == [1024, 2048, 3072, 4096]
    with pytest.raises(ValueError):
        traffic.grid(1, 2, 3, "cubic")
