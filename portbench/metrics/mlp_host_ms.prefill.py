"""mlp_host_ms.prefill (ms): the host time of a request's MLPs (the
program's ``block.mlp`` spans, ``models/blocks.py``), over the traced
slice's requests (``serve.prefill`` spans).  Like every host time read
inside the slice, it includes the profiler's own cost for each operation
and range."""

from portbench import program


def read(record):
    parts = program.prefill_parts()
    return None if parts is None else parts["mlp"]
