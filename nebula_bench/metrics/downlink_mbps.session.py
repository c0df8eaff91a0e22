"""The headset's downlink over the traced window (Mbit/s): the bytes the
benchmark's wire accounting gives each frame (the program's `sync_bytes`
are held to it frame by frame), per second of 90-FPS headset time. A
per-layer metric in session cells: one headset's bytes depend on the
street its seed puts it on (0.20 to 0.52 Mbit/s over six seeds walking,
the same to the byte on each seed's second run), too much for an
end-to-end bound."""


def read(trace):
    return trace.get("downlink_mbps")
