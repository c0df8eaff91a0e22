"""Mean host ms of `render.stages.stereo_merge` (the right eye's lists by
the shift merge, K4), the device synchronized on both sides of each span."""


def read(trace):
    ms = trace.get("spans_ms", {}).get("stereo_merge")
    return sum(ms) / len(ms) if ms else None
