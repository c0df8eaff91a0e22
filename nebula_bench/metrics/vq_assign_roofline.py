"""K5's share (%) of its roofline over the profiled window: the least time
of every encode's rows (`rooflines.k5`) over the device time of every
`vq_filter_kernel` and `vq_scan_kernel` launch."""

from nebula_bench import harness, rooflines


def read(trace):
    t, n = harness.kernel_time(trace, "vq_")
    bounds = trace.get("k5_bounds")
    if not n or not bounds:
        return None
    return 100.0 * rooflines.seconds(bounds) / t
