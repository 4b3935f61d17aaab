"""weight_cast_gb.prefill (GB): the bytes of the parameters a request casts
to the compute dtype at their use (the program's ``weight_cast.bytes``
counter, ``utils/params.py`` ``cast``: only casts that copy), over the
traced slice's requests (``serve.prefill`` spans), in 1e9 bytes."""

from portbench import program


def read(record):
    per_request = program.prefill_counter_per_request("weight_cast.bytes")
    return None if per_request is None else per_request / 1e9
