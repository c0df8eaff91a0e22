"""Kernel and memcpy/memset launches (runtime calls) a fleet sync, inside
the program's `sync` spans, over the profiled syncs."""

from nebula_bench import program_trace


def read(trace):
    return program_trace.per_step(trace, "sync", "sync", "launches")
