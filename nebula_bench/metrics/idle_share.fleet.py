"""Share (%) of a fleet's profiled window in which no operation ran on the
device: 1 − the union of the device's operation intervals / the window."""


def read(trace):
    if trace.get("kind") != "fleet":
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
