"""eager_ms_per_scene.sar (ms): the profiler's device time, in the traced
slice, of every operation launched inside a scene's span (``pb.request``)
that is not one of the port's own kernels (those launched inside a
``pb.kernel.*`` range: the wrappers of ``repro_torch.kernels``), per scene:
the pad, the complex product, the copies the plans make of their planes,
and the magnitude."""


def read(record):
    trace = record.trace
    scenes = [r for r in record.requests if r.get("in_slice")]
    if trace is None or not scenes:
        return None
    eager = trace.under_prefix("pb.request") - trace.under_prefix("pb.kernel.")
    return eager / len(scenes) * 1e3
