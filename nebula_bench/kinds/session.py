"""Driver of `session` configurations: one headset's collaborative session,
`CollaborativeSession.step(rig, render=True)` a frame (a cloud sync every
`w` frames, both eyes rendered every frame, the images finished on the
card before the next frame starts).

Set-up builds the scene, the session and its codec, runs the cold sync
(frame 0, which fills the client's store) and `warmup_frames` more; the
window then runs frames until `seconds` have passed. A traced run profiles
the window's first `trace_frames` frames and, after the window, times
`span_frames` more stage by stage."""

from __future__ import annotations

import time
from contextlib import ExitStack

import numpy as np
import torch

from nebula_bench import harness as H
from nebula_bench import port
from nebula_bench import rooflines as RF
from nebula_bench import scene as SC
from nebula_bench import traffic as TR
from nebula_bench.reference import session as RS_REF
from repro_torch.core import pipeline as P
from repro_torch.core import stereo as ST
from repro_torch.kernels import rasterize as KR
from repro_torch.kernels.stereo_shift import INF_RANK
from repro_torch.render import stages as RS

SPANS = ("frame", "session_step", "client_render_step", "project", "bin_shared",
         "stereo_merge", "rasterize")


class Run:
    """What the program reported, frame by frame (held, not copied)."""

    def __init__(self, samples):
        self.samples = set(samples)
        self.st, self.ids, self.store, self.img = {}, {}, {}, {}
        self.times, self.window = [], []

    def record(self, f, sess, fs, out, in_window: bool):
        self.st[f] = dict(synced=fs.synced, cut_size=fs.cut_size, delta_size=fs.delta_size,
                          sync_bytes=fs.sync_bytes, resweeps=fs.resweeps)
        if fs.synced:
            self.ids[f] = sess.state.cut_gids
        if f in self.samples:
            self.store[f] = sess.state.client_store
            self.img[f] = (out[0], out[1])
        if in_window:
            self.window.append(f)

    def stats(self, f):
        return self.st[f]

    def cut_ids(self, f):
        return self.ids[f]

    def store_rows(self, f, rows):
        s = self.store[f]
        return dict(mu=s.mu[rows], log_scale=s.log_scale[rows], quat=s.quat[rows],
                    opacity=s.opacity[rows], sh=s.sh[rows])

    def images(self, f):
        return self.img[f]


def session_config(cfg: dict) -> P.SessionConfig:
    s, b = cfg["session"], cfg["budgets"]
    return P.SessionConfig(tau=s["tau"], w=s["w"], w_star=s["w_star"],
                           cut_budget=b["cut_budget"], tile=s["tile"], list_len=s["list_len"],
                           max_pairs=b["max_pairs"], k_codes=s["k_codes"],
                           use_compression=True)


def run(cell: H.Cell) -> dict:
    cfg, dev = cell.config, cell.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    built = port.build_kernels(dev)
    scene = SC.build_scene(cfg, cell.seed)
    head = TR.Headset(cell.traffic, cfg["city"], cell.seed, 0)
    pos, rot = head.poses(0, cell.traffic["frames"])
    rigs = port.Rigs(cfg["rig"], pos, rot, dev)
    sess = P.CollaborativeSession(port.lod_tree(scene, dev), session_config(cfg), rigs[0],
                                  device=dev)
    warm = 1 + cfg["warmup_frames"]
    rng = np.random.default_rng(np.random.SeedSequence([cell.seed & (2**64 - 1), 3]))
    samples = [int(x) for x in rng.choice(np.arange(warm, warm + 16), 2, replace=False)]
    run_ = Run(samples)
    # a traced run holds K2's inputs on two of its window's frames
    k2_frames = {int(x) for x in rng.choice(np.arange(warm + 1, warm + 17), 2, replace=False)}
    now = [0]

    def step(f, in_window):
        now[0] = f
        if f >= len(rigs):
            rigs.extend(*head.poses(len(rigs), cell.traffic["frames"]))
        fs, out = sess.step(rigs[f], render=True)
        sync()
        run_.record(f, sess, fs, out, in_window)
        return out

    for f in range(warm):
        step(f, False)
    f = warm
    trace, spans, k2, k4 = None, None, [], []
    tracer = H.DeviceTrace(torch) if cell.trace else None
    with ExitStack() as traced:
        if tracer:
            traced.enter_context(tracer)
            step(f, False)     # the profiler's own start-up, before the window
            f += 1
            traced.enter_context(_traced(k2, k4, lambda: now[0] in k2_frames))
            traced.enter_context(tracer.window())
        t_win = time.perf_counter()
        setup_s = t_win - cell.t_start
        first = f
        while True:
            t1 = time.perf_counter()
            out = step(f, True)
            t2 = time.perf_counter()
            run_.times.append(t2 - t1)
            f += 1
            if tracer and f - first == cfg["trace_frames"]:
                traced.close()      # the profiled stretch ends; the window goes on
            if t2 - t_win >= cell.seconds:
                break
    window_s = t2 - t_win
    samples.append(f - 1)
    run_.samples.add(f - 1)
    run_.store[f - 1], run_.img[f - 1] = sess.state.client_store, (out[0], out[1])
    if cell.trace:
        spans = H.SpanTimer(sync)
        with H.patched([(P, "session_step", spans.wrap("cloud_sync", P.session_step,
                                                        keep=lambda r: bool(r[1].synced))),
                        (RS, "bin_shared", spans.wrap("bin_shared", RS.bin_shared)),
                        (RS, "stereo_merge", spans.wrap("stereo_merge", RS.stereo_merge))]):
            for _ in range(cfg["span_frames"]):
                step(f, False)
                f += 1
        trace = tracer.summary(SPANS)
        H.require_counted(trace, "rasterize_kernel", len(k2))
        H.require_counted(trace, "stereo_merge_kernel", len(k4))
    last = f - 1
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n = len(run_.window)
    fps = cell.traffic["fps"]
    e2e = dict(frame_ms=H.per_item_ms(window_s, n), frame_ms_p95=H.p95(run_.times) * 1e3,
               setup_s=setup_s)
    if trace is not None:
        synced = [g for g in run_.window if run_.st[g]["synced"]]
        trace.update(
            spans_ms=spans.ms, kind="session",
            resweeps=sum(run_.st[g]["resweeps"] for g in synced), syncs=len(synced),
            slabs=scene.meta["Ns"],
            k2_bounds=[(i, RF.k2(*RF.k2_needs(e, c, o, tile), e.shape[0], e.shape[1], tile))
                       for i, (e, c, o, tile) in enumerate(k2) if e is not None],
            k4_bounds=[RF.k4(int(live), int(cnt.clamp_max(ln).sum()), nrt, ncat, ln)
                       for live, cnt, nrt, ncat, ln in k4])
    del sess, out
    # the comparison, once the window has closed and the program's state is freed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    model = RS_REF.Model(scene, cfg, dev)
    diag = {}
    checks, wrong, pairs = RS_REF.compare(run_, model, rigs.pos, rigs.rot, last, set(samples),
                                          diag)
    # the headset's downlink by the benchmark's own wire accounting (the
    # program's `sync_bytes` are held to it frame by frame above)
    e2e["downlink_mbps"] = H.mbps(sum(model.sent[g] for g in run_.window), n, fps)
    if trace is not None:
        trace["downlink_mbps"] = e2e["downlink_mbps"]
    return dict(e2e=e2e, trace=trace, checks=checks, attempted=n,
                failed=len(wrong & set(run_.window)), memory_peak_bytes=peak,
                info=dict(**built, frames=n, last_frame=last, samples=samples, pairs_needed=pairs,
                          window_s=window_s, gaps=diag))


def _traced(k2: list, k4: list, sampled):
    """Profiler ranges around the layers, each K2 launch (its inputs held on
    the sampled frames) and each K4 launch's inputs for its roofline
    (references, and one device reduction for K4's live ranks; nothing read
    back inside the window)."""
    raster, merge = KR.rasterize_slabs, ST.stereo_merge_kernel

    def raster_rec(entries, counts, origins, *, tile, **kw):
        k2.append((entries, counts, origins, tile) if sampled() else (None,) * 4)
        return raster(entries, counts, origins, tile=tile, **kw)

    raster_rec.launches = 0     # the kernel's wrapper counts into its module's name

    def merge_rec(src_r, src_i):
        out = merge(src_r, src_i)
        k4.append(((src_r < INF_RANK).sum(), out[1], src_r.shape[0], src_r.shape[1],
                   src_r.shape[2]))
        return out

    return H.patched([(KR, "rasterize_slabs", raster_rec), (ST, "stereo_merge_kernel", merge_rec),
                      (P.CollaborativeSession, "step",
                       H.annotated(torch, "frame", P.CollaborativeSession.step)),
                      (P, "session_step", H.annotated(torch, "session_step", P.session_step)),
                      (P, "client_render_step",
                       H.annotated(torch, "client_render_step", P.client_render_step)),
                      (RS, "project", H.annotated(torch, "project", RS.project)),
                      (RS, "bin_shared", H.annotated(torch, "bin_shared", RS.bin_shared)),
                      (RS, "stereo_merge", H.annotated(torch, "stereo_merge", RS.stereo_merge)),
                      (RS, "rasterize", H.annotated(torch, "rasterize", RS.rasterize))])
