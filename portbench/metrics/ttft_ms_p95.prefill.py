"""ttft_ms_p95.prefill (ms): the 95th percentile, over every request
completed in the window, of the host time from the request's arrival (its
time on the schedule, the queueing included) until its first token has been
read back on the host.  Above the knee the queue grows all through the
window, so the tail follows the smallest change in the engine's speed; the
rate ``tokens_per_s`` is the end-to-end metric there."""

from portbench import stats


def read(record):
    return stats.percentile([r["ttft_ms"] for r in record.requests], 95)
