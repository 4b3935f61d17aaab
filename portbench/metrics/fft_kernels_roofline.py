"""fft_kernels_roofline (%): the port's kernels' share of their roofline in
the traced slice.  Each launch's least time is the bytes of the tensors it
is handed plus those it returns, each counted once, over the HBM bandwidth
(every kernel of the port is bound by bytes); the share is the sum of the
least times over the launches' summed device time (the device operations
launched inside their ``pb.kernel.*`` ranges)."""

from portbench import need


def read(record):
    trace = record.trace
    if trace is None or not record.launches:
        return None
    device_s = trace.under_prefix("pb.kernel.")
    if device_s <= 0:
        return None
    least = sum(nbytes for _, nbytes in record.launches) / need.PEAKS["hbm_bytes_per_s"]
    return least / device_s * 100.0
