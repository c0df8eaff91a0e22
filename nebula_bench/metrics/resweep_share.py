"""Share (%) of slabs the window's syncs swept again: the sum of
`StepStats.resweeps` over the window's syncs over syncs × slabs."""


def read(trace):
    if trace.get("kind") != "session" or not trace.get("syncs"):
        return None
    return 100.0 * trace["resweeps"] / (trace["syncs"] * trace["slabs"])
