"""glue_host_ms.prefill (ms): the host time of a request's ``serve.prefill``
span (``serving/engine.py``) outside its mixers, MLPs and decode-state
build: the embedding, the norms and residuals, the head and the sampling;
over the traced slice's requests.  With ``attn_host_ms.prefill``,
``spectral_host_ms.prefill``, ``mlp_host_ms.prefill`` and
``decode_state_host_ms.prefill`` it sums to the mean ``serve.prefill``
span.  Like every host time read inside the slice, it includes the
profiler's own cost for each operation and range."""

from portbench import program


def read(record):
    parts = program.prefill_parts()
    return None if parts is None else parts["glue"]
