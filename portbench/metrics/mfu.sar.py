"""mfu.sar (%): the blocks' least time on the chip over the time they took.
A block's least time is the larger of its bytes over the HBM bandwidth
(the complex64 raw block read once, the float32 image written once) and
its flops over the FP32 peak (a complex FFT of each echo line at the
linear-correlation length and its inverse, the spectrum product, the
azimuth FFT of each column: ``need.stripmap_need``), counted from the
inputs whatever the program computes; the replica's spectrum once a run.
Over the window outside the traced slice."""

from portbench import need


def read(record):
    cfg = record.config
    scenes = len(record.outside_slice())
    seconds = record.window_s - record.slice_s
    if not scenes or seconds <= 0:
        return None
    least = scenes * need.stripmap_need(cfg["n_az"], cfg["n_rg"], cfg["chirp_len"])["least_s"]
    least += need.filter_flops(cfg["n_rg"], cfg["chirp_len"]) / need.PEAKS["fp32_flops_per_s"]
    return least / seconds * 100.0
