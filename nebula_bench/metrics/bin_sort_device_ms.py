"""Device ms a frame of the work launched inside the program's `bin.sort`
span (binning's two stable argsorts and the gathers by their order), linked
to the launches by the profiler's correlation ids, over the profiled frames."""

from nebula_bench import program_trace


def read(trace):
    return program_trace.per_step(trace, "frame", "bin.sort", "device_ms")
