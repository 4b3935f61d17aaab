"""samples_per_s (Msamples/s): the input samples of every request completed
in the window, divided by the window's seconds, in millions."""

from portbench import stats


def read(record):
    return stats.rate(sum(r["work"] for r in record.requests), record.window_s) / 1e6
