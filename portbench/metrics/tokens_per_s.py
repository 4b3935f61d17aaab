"""tokens_per_s (tokens/s): the prompt tokens of every request completed in
the window, divided by the window's seconds (from its start until the last
request that arrived in it has returned its token)."""

from portbench import stats


def read(record):
    return stats.rate(sum(r["tokens"] for r in record.requests), record.window_s)
