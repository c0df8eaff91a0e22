"""The general part of the benchmark: finding a cell's files by name, the
window's statistics, spans, the device trace, the output checks and the
result line. Everything that belongs to one configuration, traffic mix or
per-layer metric lives in a file of its own:

  configs/<config>.json    a configuration (its `kind` names the driver)
  kinds/<kind>.py          the driver of a kind of configuration
  traffic/<traffic>.json   a traffic mix (`traffic.Headset` reads it)
  metrics/<metric>.py      a per-layer metric's reader: `read(trace)`

so a later change adds a cell, a mix, a configuration or a metric by adding
files and entries, without editing one that is there."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    """One run of one cell."""

    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object            # torch.device
    t_start: float            # perf_counter() of the process's start
    per_layer: list           # the per-layer metrics this cell reports (BENCHMARK.json entries)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(root: Path, workload: str) -> tuple:
    """(workload entry, configuration entry, BENCHMARK.json) of `workload`."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    return w, configs[w["config"]], bench


def applies(metric: dict, workload: dict, bench: dict) -> bool:
    """Whether a metric is reported in a cell: the cells it lists, or, where
    it lists none, every cell that reports the end-to-end metric it moves
    (an end-to-end metric without a list: every cell)."""
    if "workloads" in metric:
        return workload["name"] in metric["workloads"]
    if "moves" in metric:
        e2e = {m["name"]: m for m in bench["end_to_end"]}
        return applies(e2e[metric["moves"]], workload, bench)
    return True


def make_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
              device, t_start: float) -> Cell:
    w, c, bench = find_cell(root, workload)
    config = load_json(root / c["file"])
    traffic = load_json(root / BENCH.name / "traffic" / f"{w['traffic']}.json")
    per_layer = [dict(m, reader=metric_reader(root, m["name"]))
                 for m in bench["per_layer"] if applies(m, w, bench)]
    return Cell(name=w["name"], config_name=c["name"], config=config,
                traffic_name=w["traffic"], traffic=traffic, seed=int(seed),
                seconds=float(seconds), trace=bool(trace), device=device,
                t_start=t_start, per_layer=per_layer), w, bench


def kind_module(kind: str):
    """The driver of a configuration's kind: `kinds/<kind>.py`."""
    return importlib.import_module(f"nebula_bench.kinds.{kind}")


def metric_reader(root: Path, name: str):
    """`metrics/<name>.py`'s `read(trace)`: the metric, or None where the
    trace holds nothing for it."""
    path = root / BENCH.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"nebula_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the window's statistics ---------------------------------------------------


def per_item_ms(window_s: float, items: int) -> float:
    """A rate as a time: all the window's time over all the work it completed."""
    if items <= 0:
        raise ValueError("the window completed no work")
    return window_s * 1e3 / items


def p95(values) -> float:
    """The 95th percentile of every value (nearest rank: the smallest value
    that at least 95% of the values do not exceed)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def mbps(bytes_sent: float, frames: int, fps: float) -> float:
    """Bytes sent to one headset over `frames` of its 90-FPS time, in Mbit/s."""
    return bytes_sent * 8 / 1e6 / (frames / fps)


# -- spans ----------------------------------------------------------------------


class SpanTimer:
    """Host-clock ms of calls into a layer, the device synchronized on both
    sides (so a span holds its layer's whole device work, and traced runs
    only: the synchronizes cost idle time)."""

    def __init__(self, sync):
        self.sync = sync
        self.ms = {}

    def wrap(self, name, fn, keep=None):
        def run(*a, **kw):
            self.sync()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            self.sync()
            if keep is None or keep(r):
                self.ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            return r
        return run


def patched(targets):
    """Patch (module, attribute, replacement) triples for a `with` block."""
    from unittest import mock
    stack = contextlib.ExitStack()
    for mod, attr, fn in targets:
        stack.enter_context(mock.patch.object(mod, attr, fn))
    return stack


def annotated(torch, name, fn):
    """`fn` inside a profiler range named `name`."""
    def run(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return run


class DeviceTrace:
    """torch.profiler over a traced run: the device's busy time inside the
    host range named "window" (the union of the device's operation
    intervals, clipped to it), the device operations by name, and the idle
    gaps by the innermost host range (`annotated`) open when each began.
    The profiler starts before the window, and a step runs under it first,
    so its own start-up falls outside the window."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def window(self):
        return self.torch.profiler.record_function("window")

    def summary(self, span_names) -> dict:
        dev_type = self.torch.autograd.DeviceType.CUDA
        events = list(self.prof.events())
        win = [e.time_range for e in events
               if e.device_type != dev_type and e.name == "window"]
        if len(win) != 1:
            raise RuntimeError(f"the profiler recorded {len(win)} windows")
        w0, w1 = win[0].start, win[0].end
        # device-side copies of host ranges (user annotations) are not work
        dev = sorted(((max(e.time_range.start, w0), min(e.time_range.end, w1), e.name)
                      for e in events
                      if e.device_type == dev_type and e.name not in span_names
                      and e.name != "window" and e.time_range.end > w0
                      and e.time_range.start < w1), key=lambda x: x[0])
        if not dev:
            raise RuntimeError("the profiler recorded no device operation in the window")
        by_name, count, each = {}, {}, {}
        for s, e, n in dev:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
            count[n] = count.get(n, 0) + 1
            each.setdefault(n, []).append((s, (e - s) / 1e6))
        busy, gaps = 0.0, []
        cur_s, cur_e = dev[0][0], dev[0][1]
        if cur_s > w0:
            gaps.append((w0, cur_s))
        for s, e, _ in dev[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s = s
            cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))
        host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                       if e.device_type != dev_type and e.name in span_names),
                      key=lambda x: x[0])
        # host ranges nest, so the ranges open at a gap's start form a stack
        idle, stack, j = {}, [], 0
        for gs, ge in gaps:
            while j < len(host) and host[j][0] <= gs:
                while stack and stack[-1][1] < host[j][0]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][1] < gs:
                stack.pop()
            inner = stack[-1][2] if stack else "between steps"
            idle[inner] = idle.get(inner, 0.0) + (ge - gs) / 1e6
        return dict(busy_s=busy / 1e6, window_s=(w1 - w0) / 1e6, kernels=by_name,
                    launches=count, each=each,
                    device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
                    idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:10])


def kernel_time(trace: dict, key: str):
    """(seconds, launches) of the device operations whose names hold `key`."""
    names = [n for n in trace["kernels"] if key in n]
    return (sum(trace["kernels"][n] for n in names),
            sum(trace["launches"][n] for n in names))


def launch_seconds(trace: dict, key: str) -> list:
    """Device seconds of each launch of the kernels whose names hold `key`
    (every instantiation of a template), in launch order: one stream, so
    start order is launch order."""
    starts = sorted(x for n, xs in trace["each"].items() if key in n for x in xs)
    return [d for _, d in starts]


def require_counted(trace: dict, key: str, launched: int) -> None:
    """A kernel's device time counts only if the profiler saw every launch."""
    _, seen = kernel_time(trace, key)
    if seen != launched:
        raise RuntimeError(f"the profiler recorded {seen} launches of {key}, the program "
                           f"made {launched}")


# -- checks and the result line ---------------------------------------------------


def forbidden_modules() -> list:
    """Top-level names of loaded modules that this benchmark must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def judge(checks: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every number compared; a number with
    no limit raises."""
    out = {}
    for name, value in checks.items():
        if name not in limits:
            raise KeyError(f"no limit for the check {name!r}")
        out[name] = {"value": value, "limit": limits[name]}
    return out


def passed(judged: dict) -> bool:
    return all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
               for v in judged.values())


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                judged: dict, breakdown=None) -> str:
    out = dict(correct=bool(correct), attempted=int(attempted), failed=int(failed),
               metrics=metrics, device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = judged
    return json.dumps(out)


def print_checks(judged: dict) -> None:
    for name, v in judged.items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
