"""attn_host_ms.prefill (ms): the host time of a request's attention mixers
(the program's ``block.attn`` spans, ``models/blocks.py``, their children
included), summed over the traced slice's requests (``serve.prefill``
spans) and divided by them.  Like every host time read inside the slice,
it includes the profiler's own cost for each operation and range."""

from portbench import program


def read(record):
    parts = program.prefill_parts()
    return None if parts is None else parts["attn"]
