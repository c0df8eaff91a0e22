"""The program's spans laid over a profile (`program_trace`) and the five
readers of it, on hand-built events with hand-counted answers (times in
µs below, nanoseconds in the events)."""

import importlib.util

import pytest
import torch

from conftest import ROOT

from nebula_bench import program_trace as PT

US = 1000


def reader(name):
    path = ROOT / "nebula_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"nb_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def span(name, start, end, parent, step):
    return dict(name=name, start_ns=start * US, end_ns=end * US, parent=parent, step=step)


def session_events(lost=False):
    """Two frames in a window of [500, 16000] µs, a third after it."""
    f0, f1 = ["frame", 0], ["frame", 1]
    spans = [span("frame", 1000, 9000, None, f0), span("bin.sort", 2000, 4000, 0, f0),
             span("frame_stats", 5000, 6000, 0, f0), span("frame", 10000, 15000, None, f1),
             span("bin.sort", 11000, 12000, 3, f1),
             span("frame", 20000, 21000, None, ["frame", 2])]
    launches = [(1500, 1), (2100, 2), (2500, 3), (11500, 4), (13000, 5)]
    device = [(1600, 1800, 1), (2200, 3200, 2), (3200, 3700, 3), (11600, 11900, 4),
              (13100, 13400, 5)]
    if lost:
        launches.append((11700, 6))          # inside frame 1's bin.sort, no device event
    drained = dict(spans=spans, counters={"bin.pairs_needed": 30, "bin.pairs_sorted": 120},
                   clock="CLOCK_REALTIME ns")
    events = dict(launches=sorted((t * US, c) for t, c in launches),
                  syncs=[t * US for t in (5500, 5600, 9500, 14000)],
                  device=[(s * US, e * US, c) for s, e, c in device],
                  window=(500 * US, 16000 * US))
    return drained, events


def test_spans_get_their_launches_syncs_and_device_time():
    drained, events = session_events()
    out = PT.attribute(*session_events())
    assert [s["name"] for s in out["spans"]] == [s["name"] for s in drained["spans"][:5]]
    frame0, sort0, stats0, frame1, sort1 = out["spans"]
    assert (frame0["launches"], frame0["syncs"]) == (3, 2)
    assert frame0["device_ms"] == pytest.approx(0.2 + 1.0 + 0.5)
    assert frame0["host_ms"] == pytest.approx(8.0)
    assert (sort0["launches"], sort0["syncs"], sort0["device_ms"]) == (2, 0, pytest.approx(1.5))
    assert (stats0["launches"], stats0["syncs"], stats0["device_ms"]) == (0, 2, 0.0)
    assert (frame1["launches"], frame1["syncs"]) == (2, 1)
    assert frame1["device_ms"] == pytest.approx(0.3 + 0.3)
    assert sort1["device_ms"] == pytest.approx(0.3)
    assert out["counters"] == drained["counters"]


def test_idle_gaps_go_to_the_innermost_open_span():
    out = PT.attribute(*session_events())
    # gaps: [500, 1600] before any span, [1800, 2200] in frame 0, [3700, 11600]
    # from frame 0's bin.sort, [11900, 13100] from frame 1's, [13400, 16000]
    # in frame 1 after it
    assert dict(out["idle"]) == pytest.approx({PT.OUTSIDE: 1.1e-3, "frame": 0.4e-3 + 2.6e-3,
                                               "bin.sort": 7.9e-3 + 1.2e-3})
    assert out["idle"][0][0] == "bin.sort"
    assert out["idle_s"] == pytest.approx(13.2e-3)
    assert out["idle_in_spans_s"] == pytest.approx(12.1e-3)


def test_session_readers():
    trace = dict(program=PT.attribute(*session_events()))
    assert reader("pair_budget_use")(trace) == pytest.approx(25.0)
    assert reader("bin_sort_device_ms")(trace) == pytest.approx((1.5 + 0.3) / 2)
    assert reader("host_syncs.session")(trace) == pytest.approx((2 + 1) / 2)
    assert reader("host_syncs.fleet")(trace) is None
    assert reader("launches.fleet")(trace) is None


def test_a_launch_without_device_work_gives_no_device_time():
    out = PT.attribute(*session_events(lost=True))
    assert out["spans"][4]["device_ms"] is None and out["spans"][3]["device_ms"] is None
    assert out["spans"][0]["device_ms"] == pytest.approx(1.7)
    assert reader("bin_sort_device_ms")(dict(program=out)) is None


def test_fleet_readers():
    s0, s1 = ["sync", 0], ["sync", 1]
    drained = dict(spans=[span("sync", 1000, 5000, None, s0),
                          span("top_and_staleness", 1100, 3000, 0, s0),
                          span("sync", 6000, 8000, None, s1)], counters={})
    events = dict(launches=[(t * US, c) for c, t in enumerate((1200, 1300, 2000, 4000,
                                                                6500, 7000, 9000))],
                  syncs=[t * US for t in (2500, 6100, 6200, 7900, 8500)],
                  device=[(t * US, (t + 10) * US, c) for c, t in
                          enumerate((1250, 1350, 2050, 4050, 6550, 7050, 9050))],
                  window=None)
    trace = dict(program=PT.attribute(drained, events))
    assert reader("launches.fleet")(trace) == pytest.approx((4 + 2) / 2)
    assert reader("host_syncs.fleet")(trace) == pytest.approx((1 + 3) / 2)
    assert trace["program"]["spans"][1]["launches"] == 3
    for name in ("pair_budget_use", "bin_sort_device_ms", "host_syncs.session"):
        assert reader(name)(trace) is None


@pytest.mark.parametrize("name", ["pair_budget_use", "bin_sort_device_ms",
                                  "host_syncs.session", "host_syncs.fleet",
                                  "launches.fleet"])
def test_readers_find_nothing_in_a_trace_without_the_program(name):
    assert reader(name)(dict(kind="session", busy_s=1.0, window_s=2.0)) is None


class _Event:
    def __init__(self, name, start, dur, corr, device=False, annotation=False):
        self._n, self._s, self._d, self._c, self._dev, self._a = (name, start, dur, corr,
                                                                  device, annotation)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._a


def test_read_profile_sorts_runtime_calls_from_device_work():
    events = [_Event("window", 100, 900, 1, annotation=True),
              _Event("aten::mm", 150, 50, 2),
              _Event("cudaLaunchKernel", 160, 5, 70),
              _Event("cuLaunchKernel", 200, 5, 75),
              _Event("cudaMemcpyAsync", 300, 5, 71),
              _Event("cudaStreamSynchronize", 310, 40, 72),
              _Event("cudaMemcpy", 400, 30, 73),
              _Event("cudaGetDevice", 450, 1, 74),
              _Event("gemm_kernel", 170, 20, 70, device=True),
              _Event("Memcpy DtoH", 305, 5, 71, device=True),
              _Event("window", 100, 900, 1, device=True, annotation=True)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    got = PT.read_profile(Prof)
    assert got["window"] == (100, 1000)
    assert got["launches"] == [(160, 70), (200, 75), (300, 71), (400, 73)]
    assert got["syncs"] == [310, 400]
    assert sorted(got["device"]) == [(170, 190, 70), (305, 310, 71)]


def test_a_cpu_profile_holds_the_program_span():
    from repro_torch import tracing
    x = torch.randn(256, 256)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("window"):
            tracing.enable()
            try:
                tracing.step("frame", 0)
                with tracing.span("frame"):
                    x @ x
            finally:
                tracing.disable()
    out = PT.attribute(tracing.drain(), PT.read_profile(prof))
    (frame,) = out["spans"]
    assert (frame["name"], frame["step"], frame["launches"], frame["syncs"]) == (
        "frame", ["frame", 0], 0, 0)
    assert frame["device_ms"] == 0.0 and frame["host_ms"] > 0
