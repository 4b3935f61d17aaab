"""launch_host_ms.sar (ms): the host time of a block's kernel launch
wrappers (the program's ``kernel.<kernel>`` spans around each launch in
``kernels/*.py``: the outputs' allocation and the launch), over the blocks
of the traced slice.  Like every host time read inside the slice, it
includes the profiler's own cost for each operation and range."""

from portbench import program


def read(record):
    got = program.fft_host_ms(record)
    return None if got is None else got[1]
