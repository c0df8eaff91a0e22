"""Mean host ms of `session_step` on synced frames (the cloud's LoD sync,
its table update and Δ encode, and the client's store update), the device
synchronized on both sides of each span."""


def read(trace):
    ms = trace.get("spans_ms", {}).get("cloud_sync")
    return sum(ms) / len(ms) if ms else None
