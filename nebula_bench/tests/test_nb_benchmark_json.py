"""BENCHMARK.json: every cell finds its files by name, and the file keeps
the shape the benchmark's contract gives it."""

import json
import re
from pathlib import Path

from conftest import ROOT

from nebula_bench import harness as H

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_cell_resolves_to_its_files():
    kinds = {p.stem for p in (ROOT / "nebula_bench" / "kinds").glob("*.py")}
    for w in BENCH["workloads"]:
        _w, c, _b = H.find_cell(ROOT, w["name"])
        cfg = H.load_json(ROOT / c["file"])
        assert cfg["kind"] in kinds
        assert H.kind_module(cfg["kind"]).run
        assert (ROOT / "nebula_bench" / "traffic" / f"{w['traffic']}.json").is_file()
        metrics = [m for m in BENCH["per_layer"] if H.applies(m, w, BENCH)]
        assert metrics, w["name"]
        for m in metrics:
            assert callable(H.metric_reader(ROOT, m["name"]))
        e2e = [m["name"] for m in BENCH["end_to_end"] if H.applies(m, w, BENCH)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]


def test_the_file_keeps_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert all(not Path(p).is_absolute() and ".." not in p for p in BENCH["paths"])
    cells = {w["name"] for w in BENCH["workloads"]}
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert H.applies(e2e[m["moves"]], {"name": cell}, BENCH)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024
