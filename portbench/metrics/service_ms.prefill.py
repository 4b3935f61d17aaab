"""service_ms.prefill (ms): the mean service time of a request, from the
start of its prefill to its first token read back on the host, over the
requests outside the traced slice: the engine's part of a request's time
to first token, without the queueing."""


def read(record):
    reqs = record.outside_slice() or record.requests
    return sum(r["service_ms"] for r in reqs) / len(reqs)
