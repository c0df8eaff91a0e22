"""Share (%) of the pair budget that binning sorts which the frames needed:
Σ `bin.pairs_needed` (the (splat, tile) pairs the splats cover before the
precise cull) over Σ `bin.pairs_sorted` (`max_pairs`, sorted whatever the
need), the program's own counters over the profiled frames."""


def read(trace):
    counters = (trace.get("program") or {}).get("counters") or {}
    if not counters.get("bin.pairs_sorted"):
        return None
    return 100.0 * counters.get("bin.pairs_needed", 0) / counters["bin.pairs_sorted"]
