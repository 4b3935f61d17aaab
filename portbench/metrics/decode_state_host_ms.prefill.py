"""decode_state_host_ms.prefill (ms): the host time a request spends
building the decode state a one-token request never reads: the caches laid
out for decode (``serve.decode_layout``, ``serving/engine.py``) and the
spectral mixers' stream states (``spectral.decode_state``,
``models/layers/spectral.py``), over the traced slice's requests
(``serve.prefill`` spans).  Like every host time read inside the slice, it
includes the profiler's own cost for each operation and range."""

from portbench import program


def read(record):
    parts = program.prefill_parts()
    return None if parts is None else parts["decode_state"]
