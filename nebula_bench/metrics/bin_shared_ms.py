"""Mean host ms of `render.stages.bin_shared` (the widened left eye's tile
binning), the device synchronized on both sides of each span."""


def read(trace):
    ms = trace.get("spans_ms", {}).get("bin_shared")
    return sum(ms) / len(ms) if ms else None
