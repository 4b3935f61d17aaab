"""The general generator: requests from a traffic file's parameters and the seed.

Every seed gets the same set of sizes and arrivals, so two seeds ask for
the same work:

* prompt lengths are a fixed grid of ``distinct`` lengths over
  [``prompt_min``, ``prompt_max``], both ends included, spaced evenly or,
  with ``"spacing": "log"``, evenly in log (a log-uniform law);
* arrivals (an open loop, ``rate_per_s``) are Poisson-like: the gaps are
  the exponential law's ``distinct`` mid-quantiles at that rate, the same
  set in every cycle of ``distinct`` requests, so each cycle offers the
  rate exactly;
* the order of the lengths, and of the gaps, is drawn from
  ``schedule_seed`` where the traffic fixes one (the same schedule for
  every seed) and from the run's seed otherwise;
* token ids are drawn from the run's seed on the device.
"""

from __future__ import annotations

import math
import random

import torch


def grid(lo: int, hi: int, count: int, spacing: str = "linear") -> list:
    """``count`` lengths over [lo, hi], both ends included, spaced evenly
    (``"linear"``) or evenly in log (``"log"``)."""
    if count == 1:
        return [hi]
    if spacing == "log":
        return [round(lo * (hi / lo) ** (i / (count - 1))) for i in range(count)]
    if spacing != "linear":
        raise ValueError(f"spacing must be 'linear' or 'log', got {spacing!r}")
    return [lo + round((hi - lo) * i / (count - 1)) for i in range(count)]


def order(count: int, seed: int) -> list:
    """A permutation of range(count) drawn from ``seed``."""
    out = list(range(count))
    random.Random(seed).shuffle(out)
    return out


def schedule_seed(traffic: dict, seed: int) -> int:
    return traffic.get("schedule_seed", seed)


def prompt_lengths(traffic: dict, seed: int) -> list:
    """The prompts' lengths in serving order."""
    lengths = grid(traffic["prompt_min"], traffic["prompt_max"], traffic["distinct"],
                   traffic.get("spacing", "linear"))
    return [lengths[i] for i in order(len(lengths), schedule_seed(traffic, seed))]


def gaps(traffic: dict, seed: int) -> list:
    """One cycle's gaps between arrivals, in seconds, in order: the
    exponential law's mid-quantiles −ln(1 − (i + ½)/n) / rate."""
    n, rate = traffic["distinct"], traffic["rate_per_s"]
    quantiles = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    return [quantiles[i] for i in order(n, schedule_seed(traffic, seed) + 1)]


def arrival(cycle_gaps: list, i: int) -> float:
    """The arrival of request ``i`` (0, 1, …) in seconds from the window's
    start: the gaps summed, cycle after cycle."""
    cycles, rest = divmod(i, len(cycle_gaps))
    return cycles * sum(cycle_gaps) + sum(cycle_gaps[:rest])


def prompts(traffic: dict, seed: int, vocab: int, device) -> list:
    """The prompts, (1, S) int64 each on ``device``, in serving order; ids
    uniform over the vocabulary, made in one draw."""
    lengths = prompt_lengths(traffic, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = torch.randint(vocab, (sum(lengths),), generator=gen, device=device)
    return [chunk[None, :] for chunk in torch.split(ids, lengths)]
