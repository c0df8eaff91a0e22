"""Mean host ms a fleet sync spends in `serve.delta_path.build_delta_batch`
(the Δ-union, its ranking into pages and its one encode), the device
synchronized on both sides of each span."""


def read(trace):
    ms = trace.get("spans_ms", {}).get("union_and_encode")
    return sum(ms) / len(ms) if ms else None
