"""call_ms_p95 (ms): the 95th percentile, over every request completed in the
window, of the request's span on the device stream (a CUDA event recorded
before its first call to one recorded after its last)."""

from portbench import stats


def read(record):
    return stats.percentile([r["span_ms"] for r in record.requests], 95)
