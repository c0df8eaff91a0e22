"""Mean host ms a fleet sync spends in `lod_search.batched_top_and_staleness`
(every slot's top-tree sweep and slab staleness test), the device
synchronized on both sides of each span."""


def read(trace):
    ms = trace.get("spans_ms", {}).get("top_and_staleness")
    return sum(ms) / len(ms) if ms else None
