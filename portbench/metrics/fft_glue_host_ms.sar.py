"""fft_glue_host_ms.sar (ms): the host time of a block's planned FFTs
(the program's ``fft.apply_planes`` spans, ``core/fft.py`` through
``kernels/ops.py``) less the kernel launch wrappers inside them
(``kernel.*`` spans), over the blocks of the traced slice.  Like every host
time read inside the slice, it includes the profiler's own cost for each
operation and range."""

from portbench import program


def read(record):
    got = program.fft_host_ms(record)
    return None if got is None else got[0]
