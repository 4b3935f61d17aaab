"""spectral_ms_per_ktok.prefill (ms): the profiler's device time of the
operations launched inside the spectral mixers' forward
(``models/layers/spectral.py``, through ``core/conv.py`` to the kernels;
ranges ``pb.spectral``) in the traced slice, per 1000 prompt tokens
prefilled in it."""


def read(record):
    trace = record.trace
    tokens = sum(r["tokens"] for r in record.requests if r.get("in_slice"))
    if trace is None or not tokens:
        return None
    return trace.under_prefix("pb.spectral") * 1e3 / (tokens / 1e3)
