"""K6's share (%) of its roofline over the profiled window: the least time
of every pooled sweep's pairs (`rooflines.k6`) over the device time of
every `lod_sweep_kernel` launch (the fleet launches K6 alone)."""

from nebula_bench import harness, rooflines


def read(trace):
    t, n = harness.kernel_time(trace, "lod_sweep_kernel")
    bounds = trace.get("k6_bounds")
    if not n or not bounds:
        return None
    return 100.0 * rooflines.seconds(bounds) / t
