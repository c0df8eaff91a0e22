"""K2's share (%) of its roofline: over the launches of two frames of
the profiled window drawn from the seed (both eyes), the least time of each
launch's work (`rooflines.k2`, counted from its inputs by
`rooflines.k2_needs`) over the device time of the same launches of
`rasterize_kernel`."""

from nebula_bench import harness, rooflines


def read(trace):
    sampled = trace.get("k2_bounds")
    if not sampled:
        return None
    each = harness.launch_seconds(trace, "rasterize_kernel")
    return (100.0 * rooflines.seconds([b for _, b in sampled])
            / sum(each[i] for i, _ in sampled))
