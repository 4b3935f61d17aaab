"""plane_copy_mb.sar (MB): the bytes written by the copies the FFT API and
the executor make of a block's planes (the program's ``plane_copy.bytes``
counter: ``core/fft.py``'s dtype conversions, joins and contiguous copies,
``kernels/ops.py``'s contiguous copies, each counted only where a copy is
made), over the blocks of the traced slice, in 1e6 bytes."""

from portbench import program


def read(record):
    per_block = program.counter_per_block(record, "plane_copy.bytes")
    return None if per_block is None else per_block / 1e6
