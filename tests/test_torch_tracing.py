"""The port's spans and counters (`repro_torch.tracing`): off, they record
nothing and change no result; on, a session frame and a fleet sync record
the span tree of the tracing module's docstring, the binning counters count
what the frame needs and sorts, and the spans sit on the profiler's clock."""

import numpy as np
import pytest
import torch

from _torch_parity import CPU, to_torch_tree

from repro_torch import tracing
from repro_torch.core import pipeline as P
from repro_torch.core.camera import StereoRig, make_camera
from repro_torch.render.config import RenderConfig
from repro_torch.serve.lod_service import LodService

CFG = P.SessionConfig(tau=32.0, w=2, w_star=2, cut_budget=8192, tile=16, list_len=256,
                      max_pairs=1 << 16)
FRAMES = 2            # frame 0 syncs, frame 1 renders the cached cut
SESSION_TREE = {
    "frame": None, "cloud_sync": "frame", "lod_search": "cloud_sync",
    "manager": "cloud_sync", "encode": "cloud_sync", "client_update": "cloud_sync",
    "frame_stats": "frame", "client_render": "frame", "project": "client_render",
    "bin_shared": "client_render", "bin.expand": "bin_shared", "bin.sort": "bin_shared",
    "bin.lists": "bin_shared", "stereo_merge": "client_render",
    "rasterize": "client_render", "stereo_stats": "client_render"}
SYNC_TREE = {"sync": None, "top_and_staleness": "sync", "pair_sweep": "sync",
             "tables": "sync", "union_and_encode": "sync"}


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _rig(k: int) -> StereoRig:
    pos = [30.0 + 0.5 * k, 30.0, 1.7]
    return StereoRig(left=make_camera(pos, [60, 60, 1.5], focal_px=200.0, width=96,
                                      height=64, near=0.2, device=CPU), baseline=0.06)


def _frames(tree, on: bool):
    sess = P.CollaborativeSession(tree, CFG, _rig(0), device=CPU)
    if on:
        tracing.enable()
    out = [sess.step(_rig(k)) for k in range(FRAMES)]
    tracing.disable()
    return out, tracing.drain()


@pytest.fixture(scope="module")
def runs(small_tree):
    tracing.disable()
    tree = to_torch_tree(small_tree)
    off, off_drained = _frames(tree, False)
    on, on_drained = _frames(tree, True)
    return off, off_drained, on, on_drained


def _same(a, b):
    if isinstance(a, torch.Tensor):         # bit for bit, NaNs too
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        for f in a.__dataclass_fields__:
            _same(getattr(a, f), getattr(b, f))
    else:
        assert a == b


def test_off_records_nothing_and_on_changes_no_result(runs):
    off, off_drained, on, _ = runs
    assert off_drained["spans"] == [] and off_drained["counters"] == {}
    assert tracing.span("a") is tracing.span("b")      # the one shared no-op
    tracing.count("bin.pairs_needed", torch.tensor(3))
    tracing.step("frame", 7)
    assert tracing.drain() == dict(spans=[], counters={}, clock=tracing.CLOCK)
    assert off[0][0].synced and not off[1][0].synced
    for (st_off, out_off), (st_on, out_on) in zip(off, on):
        assert st_off == st_on
        _same(out_off, out_on)          # both images, splats, both eyes' lists, stats


def test_a_session_frame_records_the_span_tree(runs):
    _, _, _, drained = runs
    spans = drained["spans"]
    assert drained["clock"] == "CLOCK_REALTIME ns"
    for f in range(FRAMES):
        mine = [s for s in spans if s["step"] == ["frame", f]]
        names = [s["name"] for s in mine]
        expect = [n for n in SESSION_TREE
                  if f == 0 or n not in ("cloud_sync", "lod_search", "manager", "encode",
                                         "client_update")]
        assert sorted(names) == sorted(expect), f
        for s in mine:
            parent = SESSION_TREE[s["name"]]
            assert (spans[s["parent"]]["name"] if s["parent"] is not None else None) == parent
            if s["parent"] is not None:
                outer = spans[s["parent"]]
                assert outer["start_ns"] <= s["start_ns"] <= s["end_ns"] <= outer["end_ns"]
    # a frame's spans open in program order
    order = [s["name"] for s in spans if s["step"] == ["frame", 0]]
    assert order[:3] == ["frame", "cloud_sync", "lod_search"]
    assert order.index("frame_stats") < order.index("client_render") < order.index("project")
    assert order.index("bin.sort") < order.index("stereo_merge") < order.index("rasterize")


def _pairs_needed(splats, width: int, height: int, tile: int) -> int:
    """Σ span_w·span_h over the splats, in numpy from the splats alone."""
    m = splats.mean2d.numpy().astype(np.float32)
    e = splats.ext.numpy().astype(np.float32)
    vis = (splats.visible.numpy() & (m[:, 0] + e[:, 0] >= 0) & (m[:, 0] - e[:, 0] <= width)
           & (m[:, 1] + e[:, 1] >= 0) & (m[:, 1] - e[:, 1] <= height))
    tx, ty = -(-width // tile), -(-height // tile)

    def cell(v, n):
        return np.clip(np.floor(v / np.float32(tile)), 0, n - 1).astype(np.int64)

    w = cell(m[:, 0] + e[:, 0], tx) - cell(m[:, 0] - e[:, 0], tx) + 1
    h = cell(m[:, 1] + e[:, 1], ty) - cell(m[:, 1] - e[:, 1], ty) + 1
    return int((w * h)[vis].sum())


def test_binning_counters_count_need_and_budget(runs):
    _, _, on, drained = runs
    rcfg = RenderConfig.for_rig(_rig(0), tile=CFG.tile, list_len=CFG.list_len,
                                max_pairs=CFG.max_pairs)
    need = sum(_pairs_needed(out[2][0], rcfg.wide_width, rcfg.height, CFG.tile)
               for _, out in on)
    assert need > 0
    assert drained["counters"] == {"bin.pairs_needed": need,
                                   "bin.pair_budget": FRAMES * CFG.max_pairs,
                                   "bin.pairs_sorted": FRAMES * CFG.max_pairs}


def test_a_fleet_sync_records_sync_and_its_four_stages(small_tree):
    svc = LodService(to_torch_tree(small_tree), CFG, 2, focal=200.0, device=CPU)
    cams = np.array([[30.0, 30.0, 1.7], [60.0, 40.0, 1.7]], np.float32)
    svc.sync(cams)                       # off: records nothing, counts the sync
    tracing.enable()
    svc.sync(cams)
    svc.sync(cams + 0.5)
    tracing.disable()
    spans = tracing.drain()["spans"]
    for k in (1, 2):
        mine = [s for s in spans if s["step"] == ["sync", k]]
        assert sorted(s["name"] for s in mine) == sorted(SYNC_TREE), k
        for s in mine:
            parent = SYNC_TREE[s["name"]]
            assert (spans[s["parent"]]["name"] if s["parent"] is not None else None) == parent


def test_spans_share_the_profilers_clock():
    x = torch.randn(384, 384)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tracing.enable()
        with tracing.span("mm"):
            x @ x
        tracing.disable()
    (mm,) = tracing.drain()["spans"]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    (ev,) = [e for e in prof.events() if e.name == "aten::mm"]
    start, end = t0 + ev.time_range.start * 1000, t0 + ev.time_range.end * 1000
    slack = 200_000                       # ns
    assert mm["start_ns"] - slack <= start <= end <= mm["end_ns"] + slack
    assert end - start > 0
