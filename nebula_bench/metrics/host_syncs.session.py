"""Blocking host syncs a frame (stream, device and event synchronizes and
synchronous copies the profiler recorded inside the program's `frame`
spans), over the profiled frames. The benchmark's own synchronize after
each frame falls outside the span."""

from nebula_bench import program_trace


def read(trace):
    return program_trace.per_step(trace, "frame", "frame", "syncs")
