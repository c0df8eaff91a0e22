"""The dry-run and roofline tables of the cell JSONs (`launch/dryrun.py`): the
port of `repro.launch.report`, against the 80 GB of an NVIDIA H100 80GB HBM3
(the reference checks 16 GB, a TPU v5e's). The port traces, it does not
compile, so the time column is each cell's trace.

    PYTHONPATH=src python -m repro_torch.launch.report --dir experiments/dryrun
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List

HBM_PER_CHIP = 80e9  # NVIDIA H100 80GB HBM3


def load(dir_: str) -> List[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def fmt_bytes(b: float) -> str:
    return f"{b/1e9:.2f}"


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-4:
        return f"{x*1e6:.1f}µs"
    if x < 0.1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.3f}s"


def dryrun_table(rows: List[dict]) -> str:
    out = ["| arch | shape | mesh | status | mem/dev GB | trace s | collective schedule (counts) |",
           "|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP | — | — | {r['reason'][:60]} |")
            continue
        if r["status"] == "error":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR | — | — | {r['error'][:60]} |")
            continue
        mem = (r["memory"]["argument_bytes"] + r["memory"]["temp_bytes"]
               + r["memory"]["output_bytes"]) / 1e9
        c = r["collectives"]
        sched = " ".join(f"{k.split('_')[0]}×{int(c[k])}"
                         for k in sorted(c) if k.endswith("_count") and c[k])
        fit = "" if mem * 1e9 <= HBM_PER_CHIP else f" ⚠>{HBM_PER_CHIP / 1e9:.0f}GB"
        out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok{fit} | "
                   f"{mem:.2f} | {r['trace_s']:.0f} | {sched or '—'} |")
    return "\n".join(out)


def roofline_table(rows: List[dict], mesh: str = "single") -> str:
    out = ["| arch | shape | compute | memory | collective | dominant | MODEL_FLOPS | useful | roofline-frac | what moves the bottleneck |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok" or r["mesh"] != mesh:
            continue
        rf = r["roofline"]
        hint = bottleneck_hint(r)
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(rf['compute_s'])} | "
            f"{fmt_s(rf['memory_s'])} | {fmt_s(rf['collective_s'])} | "
            f"**{rf['dominant']}** | {rf['model_flops']:.2e} | "
            f"{rf['useful_flops_ratio']:.2f} | {rf['roofline_fraction']:.3f} | {hint} |")
    return "\n".join(out)


def bottleneck_hint(r: dict) -> str:
    dom = r["roofline"]["dominant"]
    fam_moe = r.get("model_params_active", 0) != r.get("model_params", 1)
    if dom == "collective":
        if fam_moe:
            return "fuse EP dispatch a2a; bf16 collectives; widen capacity locality"
        return "bf16 grad all-reduce; reduce-scatter instead of AR; overlap with compute"
    if dom == "memory":
        if r["mode"] == "decode":
            return "KV-cache reads dominate — quantize cache / fuse attention"
        return "bf16 intermediates + fewer fusion round-trips (remat policy)"
    return "already compute-bound — increase arithmetic intensity only"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    args = ap.parse_args()
    rows = load(args.dir)
    ok = [r for r in rows if r["status"] == "ok"]
    print(f"cells: {len(rows)} total, {len(ok)} ok, "
          f"{sum(1 for r in rows if r['status']=='skip')} skip, "
          f"{sum(1 for r in rows if r['status']=='error')} error\n")
    print("## Dry-run\n")
    print(dryrun_table(rows))
    print("\n## Roofline (single-pod 16×16)\n")
    print(roofline_table(rows, "single"))
    print("\n## Roofline (multi-pod 2×16×16)\n")
    print(roofline_table(rows, "multi"))


if __name__ == "__main__":
    main()
