"""Readers of the program's own spans and counters
(``repro_torch.runtime.tracing``), which the program records while the
traced slice's profiler runs: the record is the slice's.

Every reader returns None where there is nothing to read: a program
without the tracing module, an empty record, or one that dropped spans.
The host times include the profiler's own cost for each operation and
range, as every reading taken inside the slice does.  That cost is paid
per operation, so a part made of many small operations grows more than the
rest and the prefill's five parts are shares weighted by it: ``PERF.md``
§3 gives each part's growth against the same spans timed with no profiler.
"""

from __future__ import annotations

#: The prefill's host parts, which partition the ``serve.prefill`` spans.
PREFILL_PARTS = ("attn", "spectral", "mlp", "decode_state", "glue")


def tracing_record():
    """(the tracing module, the slice's record), or None."""
    try:
        from repro_torch.runtime import tracing
    except ImportError:  # a program that records no span of its own
        return None
    rec = tracing.record()
    if not rec.spans or rec.dropped:
        return None
    return tracing, rec


def prefill_parts():
    """The mean host milliseconds of a request's ``serve.prefill`` span,
    split into five parts that sum to it: the attention mixers
    (``block.attn``), the spectral mixers less the decode state they build
    (``block.spectral``), the MLPs (``block.mlp``), the decode-state build
    (``serve.decode_layout`` and the mixers' ``spectral.decode_state``),
    and the rest (embedding, norms and residuals, head, sampling).  With
    ``requests`` (the spans) and ``total`` (their mean)."""
    got = tracing_record()
    if got is None:
        return None
    tracing, rec = got
    requests = sum(1 for s in rec.spans if s.name == "serve.prefill" and s.end_ns >= 0)
    if not requests:
        return None
    inside = tracing.inclusive_ms(rec, under="serve.prefill")
    states = tracing.inclusive_ms(rec, under="block.spectral").get("spectral.decode_state", 0.0)
    total = tracing.inclusive_ms(rec)["serve.prefill"]
    parts = {
        "attn": inside.get("block.attn", 0.0),
        "spectral": inside.get("block.spectral", 0.0) - states,
        "mlp": inside.get("block.mlp", 0.0),
        "decode_state": inside.get("serve.decode_layout", 0.0) + inside.get("spectral.decode_state", 0.0),
    }
    parts["glue"] = total - sum(parts.values())
    out = {k: v / requests for k, v in parts.items()}
    out.update(requests=requests, total=total / requests)
    return out


def prefill_counter_per_request(name: str):
    """The counter ``name`` over the slice's ``serve.prefill`` spans."""
    got = tracing_record()
    if got is None:
        return None
    _, rec = got
    requests = sum(1 for s in rec.spans if s.name == "serve.prefill" and s.end_ns >= 0)
    return rec.counters.get(name, 0) / requests if requests else None


def blocks_in_slice(record) -> int:
    return sum(1 for r in record.requests if r.get("in_slice"))


def fft_host_ms(record):
    """(``fft.apply_planes`` less its ``kernel.*`` spans, the ``kernel.*``
    spans) in host milliseconds per block of the slice."""
    got = tracing_record()
    blocks = blocks_in_slice(record)
    if got is None or not blocks:
        return None
    tracing, rec = got
    inclusive = tracing.inclusive_ms(rec)
    apply = inclusive.get("fft.apply_planes")
    if apply is None:
        return None
    launches = sum(ms for name, ms in inclusive.items() if name.startswith("kernel."))
    in_apply = sum(ms for name, ms in tracing.inclusive_ms(rec, under="fft.apply_planes").items()
                   if name.startswith("kernel."))
    return (apply - in_apply) / blocks, launches / blocks


def counter_per_block(record, name: str):
    """The counter ``name`` over the slice's blocks."""
    got = tracing_record()
    blocks = blocks_in_slice(record)
    if got is None or not blocks:
        return None
    return got[1].counters.get(name, 0) / blocks
