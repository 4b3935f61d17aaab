"""spectral_host_ms.prefill (ms): the host time of a request's spectral
mixers (the program's ``block.spectral`` spans, through ``core/conv.py``,
``core/fft.py`` and ``kernels/ops.py`` to the kernels' launches) less the
decode state they build (``spectral.decode_state``), over the traced
slice's requests (``serve.prefill`` spans).  Like every host time read
inside the slice, it includes the profiler's own cost for each operation
and range."""

from portbench import program


def read(record):
    parts = program.prefill_parts()
    return None if parts is None else parts["spectral"]
