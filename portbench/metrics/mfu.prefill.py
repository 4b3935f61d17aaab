"""mfu.prefill (%): the flops the prefills need over what the card's bf16
peak (989 TFLOP/s) gives in the time the engine spent serving them (each
request's start of prefill to its token on the host: the time waiting for
arrivals is left out, so the share follows the engine's speed and not the
offered load).  Each prompt's flops are counted from the configuration and
its length, whatever implements them (``need.prefill_flops``: the matrix
products, the head at the last position only, causal attention's QK and PV
products, the spectral mixers' transforms at their need).  Over the
requests outside the traced slice."""

from portbench import need


def read(record):
    reqs = record.outside_slice()
    seconds = sum(r["service_ms"] for r in reqs) / 1e3
    if not reqs or seconds <= 0:
        return None
    flops = sum(need.prefill_flops(record.config, r["tokens"]) for r in reqs)
    return flops / (need.PEAKS["bf16_flops_per_s"] * seconds) * 100.0
