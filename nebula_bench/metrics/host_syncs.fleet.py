"""Blocking host syncs a fleet sync (stream, device and event synchronizes
and synchronous copies the profiler recorded inside the program's `sync`
spans), over the profiled syncs. The benchmark's own synchronize after
each sync falls outside the span."""

from nebula_bench import program_trace


def read(trace):
    return program_trace.per_step(trace, "sync", "sync", "syncs")
