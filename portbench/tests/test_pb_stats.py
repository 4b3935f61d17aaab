"""The end-to-end statistics: the rate over the whole window, the p95 over
every request, and the spread that sizes a bound."""

import statistics

import numpy as np
import pb_tiny  # noqa: F401
import pytest

from portbench import common, need, stats
from portbench.harness import Record


@pytest.mark.parametrize("n", [1, 2, 7, 20, 201, 1000])
def test_percentile_matches_numpy(n):
    xs = list(np.random.default_rng(n).exponential(size=n))
    for q in (0, 50, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_spread_is_statistics_quartiles_over_median():
    xs = [10.0, 11.0, 9.5, 10.2, 10.4, 9.9]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def record(requests, window_s):
    return Record(config={}, traffic={}, window_s=window_s, requests=requests, attempted=len(requests))


def metric(name):
    from portbench import common

    return common.load("metrics", name)


def test_rates_cover_every_request_over_the_whole_window():
    reqs = [{"work": 1000, "tokens": 100 + i, "span_ms": float(i), "ttft_ms": 2.0 * i, "service_ms": 50.0}
            for i in range(40)]
    rec = record(reqs, 4.0)
    rec.config = common.config("h2o-danube-1.8b-spectral")
    assert metric("samples_per_s").read(rec) == pytest.approx(40 * 1000 / 4.0 / 1e6)
    assert metric("tokens_per_s").read(rec) == pytest.approx(sum(100 + i for i in range(40)) / 4.0)
    # The prefill's share of the peak is over the time the engine served
    # (40 × 50 ms), not over the window, which also waits for arrivals.
    flops = sum(need.prefill_flops(rec.config, 100 + i) for i in range(40))
    assert metric("mfu.prefill").read(rec) == pytest.approx(flops / (989e12 * 2.0) * 100)
    assert metric("service_ms.prefill").read(rec) == pytest.approx(50.0)


def test_tails_are_over_every_request():
    reqs = [{"span_ms": float(i), "ttft_ms": 2.0 * i} for i in range(200)]
    rec = record(reqs, 1.0)
    assert metric("call_ms_p95").read(rec) == pytest.approx(float(np.percentile(range(200), 95)))
    assert metric("ttft_ms_p95.prefill").read(rec) == pytest.approx(2.0 * float(np.percentile(range(200), 95)))


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        stats.percentile([], 95)
