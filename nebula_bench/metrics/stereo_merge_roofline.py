"""K4's share (%) of its roofline over the profiled window: the least time
of every launch's work (`rooflines.k4`) over the device time of every
`stereo_merge_kernel` launch."""

from nebula_bench import harness, rooflines


def read(trace):
    t, n = harness.kernel_time(trace, "stereo_merge_kernel")
    bounds = trace.get("k4_bounds")
    if not n or not bounds:
        return None
    return 100.0 * rooflines.seconds(bounds) / t
