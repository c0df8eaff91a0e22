"""Puts the checkout's root and `src/` on the path, and builds a copy of the
benchmark at a tiny size (a 2×2-block city, 96×64 eyes, 3 fleet clients)
that runs on the CPU through the port's plain versions."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def shrink(cfg: dict) -> dict:
    cfg["city"].update(blocks_x=2, blocks_y=2)
    cfg["tree"]["target_subtrees"] = 16
    cfg["rig"].update(width=96, height=64, focal=80.0)
    cfg["budgets"].update(cut_budget=65536)
    if "max_pairs" in cfg["budgets"]:
        cfg["budgets"]["max_pairs"] = 1 << 20
    if "fleet" in cfg:
        cfg["fleet"]["clients"] = 3
    # set-up holds two syncs, so a fault planted from the start shows in the
    # frames every run compares, however few frames a slow CPU's window holds
    for key, value in (("warmup_frames", 4), ("span_frames", 2), ("warmup_syncs", 2),
                       ("span_syncs", 2)):
        if key in cfg:
            cfg[key] = value
    return cfg


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A checkout-shaped copy: BENCHMARK.json and `nebula_bench/` with every
    configuration shrunk."""
    shutil.copytree(ROOT / "nebula_bench", tmp_path / "nebula_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = shrink(json.loads((ROOT / c["file"]).read_text()))
        (tmp_path / c["file"]).write_text(json.dumps(cfg))
    # the fleet riding: a cell of the tests alone (its runs on the card spread
    # too widely for a bound), whose Δs are large enough to show every fault
    bench["workloads"].append(dict(name="fleet.vehicle", config="city24-fleet16",
                                   traffic="vehicle", chips=1, why="tests"))
    for m in bench["end_to_end"]:
        if "city24-fleet16.walk" in m.get("workloads", ()):
            m["workloads"].append("fleet.vehicle")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path
