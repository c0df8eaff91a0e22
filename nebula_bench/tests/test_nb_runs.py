"""Whole runs on the CPU at a tiny size (the port's plain versions): the
reference agrees with the port, and a cell added as new files only runs."""

import json
import time

import pytest
import torch

from nebula_bench import run as R

CPU = torch.device("cpu")
SEED = 2**31 + 12345          # past 32 signed bits, as the driver's seeds are


def run(root, workload, seconds=2.0, seed=SEED):
    line, judged = R.run_cell(root, workload, seed, seconds, False, CPU, time.perf_counter())
    return json.loads(line), judged


@pytest.mark.parametrize("workload", ["city24-quest3.walk", "fleet.vehicle"])
def test_reference_agrees_with_the_port(tiny_root, workload):
    out, judged = run(tiny_root, workload)
    assert out["correct"], judged
    assert out["attempted"] > 0 and out["failed"] == 0
    for name in ("cut_ids_off", "counts_off", "delta_rows_off"):
        if name in judged:
            assert judged[name]["value"] == 0
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"]


def test_a_cell_added_as_new_files_runs(tiny_root):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny_root / "nebula_bench/configs/city24-quest3.json").read_text())
    cfg["session"]["tau"] = 64.0
    (tiny_root / "nebula_bench/configs/tiny-new.json").write_text(json.dumps(cfg))
    traffic = json.loads((tiny_root / "nebula_bench/traffic/walk.json").read_text())
    traffic["speed_mps"] = 3.0
    (tiny_root / "nebula_bench/traffic/stroll.json").write_text(json.dumps(traffic))
    (tiny_root / "nebula_bench/metrics/frames_seen.py").write_text(
        "def read(trace):\n    return None\n")
    bench["configs"].append(dict(bench["configs"][0], name="tiny-new",
                                 file="nebula_bench/configs/tiny-new.json"))
    bench["workloads"].append(dict(name="tiny-new.stroll", config="tiny-new",
                                   traffic="stroll", chips=1, why="a throwaway cell"))
    for m in bench["end_to_end"]:
        if "workloads" in m and "city24-quest3.walk" in m["workloads"]:
            m["workloads"].append("tiny-new.stroll")
    bench["per_layer"].append(dict(bench["per_layer"][0], name="frames_seen",
                                   workloads=["tiny-new.stroll"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    out, judged = run(tiny_root, "tiny-new.stroll")
    assert out["correct"], judged
    assert {"frame_ms", "frame_ms_p95", "setup_s"} <= set(out["metrics"])
