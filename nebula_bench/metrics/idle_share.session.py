"""Share (%) of a session's profiled window in which no operation ran on
the device: 1 − the union of the device's operation intervals / the
window."""


def read(trace):
    if trace.get("kind") != "session":
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
