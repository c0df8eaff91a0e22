"""A fleet's downlink over the traced window (Mbit/s): each client's
`ServiceStats.sync_bytes` over every sync (held to the reference's on the
sampled syncs), per second of its 90-FPS time, the mean over clients. A
per-layer metric: the bytes depend on the streets a seed puts the
headsets on (0.304 to 0.366 Mbit/s over six seeds walking, the same to
the byte on each seed's second run), too much for an end-to-end bound."""


def read(trace):
    return trace.get("downlink_mbps")
