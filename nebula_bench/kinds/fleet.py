"""Driver of `fleet` configurations: one cloud GPU serving a fleet of
headsets, `LodService.sync(cams)` a step (every live client's LoD sync,
pooled over the fleet; the tables; the encode-once paged Δ-union), the
stats and the payload finished on the card before the next sync starts.
Each sync advances every headset `w` frames of its own path.

Set-up builds the scene and the service and runs the cold sync (which
ships every client's whole cut) and `warmup_syncs` more; the window then
runs syncs until `seconds` have passed. A traced run profiles the
window's first `trace_syncs` syncs and, after the window, times
`span_syncs` more stage by stage."""

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
from nebula_bench.reference import fleet as RF_REF
from repro_torch.core import lod_search as LS
from repro_torch.core import manager as MG
from repro_torch.core.pipeline import SessionConfig
from repro_torch.serve import delta_path as DP
from repro_torch.serve import lod_service as SV

SPANS = ("sync", "top_and_staleness", "pair_sweep", "tables", "union_and_encode")


class Run:
    """What the program reported, sync by sync (held, not copied)."""

    def __init__(self, samples):
        self.samples = set(samples)
        self.st, self.held, self.window = {}, {}, []

    def record(self, k, service, stats, in_window: bool):
        self.st[k] = stats
        if k in self.samples:
            self.held[k] = (service.state.cut_gids, service.last_delta)
        if in_window:
            self.window.append(k)

    def finish(self, service, sh_k: int):
        """Read the stats back and decode the held payloads (the clients'
        side), once the window has closed."""
        self.stats_host = {k: dict(cut_size=s.cut_size.tolist(),
                                   delta_size=s.delta_size.tolist(),
                                   sync_bytes=s.sync_bytes.tolist(),
                                   resweeps=s.resweeps.tolist())
                           for k, s in self.st.items()}
        self.dec = {}
        for k, (gids, batch) in self.held.items():
            shipped = batch.union_gids >= 0
            _ids, rows = DP.decode_client(service.codec, batch, sh_k, 0)
            self.dec[k] = (gids, batch.union_gids[shipped], batch.ref_mask[:, shipped],
                           {f: getattr(rows, f)[shipped] for f in
                            ("mu", "log_scale", "quat", "opacity", "sh")})

    def stats(self, k):
        return self.stats_host[k]

    def cut_ids(self, k, b):
        return self.dec[k][0][b]

    def union(self, k):
        return self.dec[k][1]

    def client_rows(self, k, b):
        return self.dec[k][1][self.dec[k][2][b]]

    def decoded(self, k):
        return self.dec[k][3]


def run(cell: H.Cell) -> dict:
    cfg, dev = cell.config, cell.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    s, fl, b = cfg["session"], cfg["fleet"], cfg["budgets"]
    n, w = fl["clients"], s["w"]
    built = port.build_kernels(dev)
    scene = SC.build_scene(cfg, cell.seed)
    heads = [TR.Headset(cell.traffic, cfg["city"], cell.seed, c) for c in range(n)]
    horizon = cell.traffic["frames"] // w

    def cams_for(first, count):
        frames = [h.poses(first * w, count * w)[0][::w] for h in heads]
        return np.stack(frames, 1)                   # (count, clients, 3)

    cams = cams_for(0, horizon)
    scfg = SessionConfig(tau=float(fl["taus"][0]), w=w, w_star=s["w_star"],
                            cut_budget=b["cut_budget"], tile=s["tile"],
                            list_len=s["list_len"], k_codes=s["k_codes"])
    taus = np.array([fl["taus"][c % len(fl["taus"])] for c in range(n)], np.float32)
    service = SV.LodService(port.lod_tree(scene, dev), scfg, n, focal=cfg["rig"]["focal"],
                            mode="pooled", taus=taus, delta_budget=b["delta_budget"],
                            page_size=b["page_size"], device=dev)
    warm = 1 + cfg["warmup_syncs"]
    rng = np.random.default_rng(np.random.SeedSequence([cell.seed & (2**64 - 1), 3]))
    samples = [int(x) for x in rng.choice(np.arange(warm, warm + 8), 2, replace=False)]
    run_ = Run(samples)

    def step(k, in_window):
        nonlocal cams
        if k >= len(cams):
            cams = np.concatenate([cams, cams_for(len(cams), horizon)])
        stats = service.sync(cams[k])
        sync()
        run_.record(k, service, stats, in_window)

    for k in range(warm):
        step(k, False)
    k = warm
    trace, k6, k5 = None, [], []
    tracer = H.DeviceTrace(torch) if cell.trace else None
    with ExitStack() as traced:
        if tracer:
            traced.enter_context(tracer)
            step(k, False)     # the profiler's own start-up, before the window
            k += 1
            traced.enter_context(_traced(k6, k5))
            traced.enter_context(tracer.window())
        t_win = time.perf_counter()
        setup_s = t_win - cell.t_start
        first = k
        while True:
            step(k, True)
            t2 = time.perf_counter()
            k += 1
            if tracer and k - first == cfg["trace_syncs"]:
                traced.close()      # the profiled stretch ends; the window goes on
            if t2 - t_win >= cell.seconds:
                break
    window_s = t2 - t_win
    samples.append(k - 1)
    run_.samples.add(k - 1)
    run_.held[k - 1] = (service.state.cut_gids, service.last_delta)
    if cell.trace:
        spans = H.SpanTimer(sync)
        with H.patched([(LS, "batched_top_and_staleness",
                         spans.wrap("top_and_staleness", LS.batched_top_and_staleness)),
                        (DP, "build_delta_batch",
                         spans.wrap("union_and_encode", DP.build_delta_batch))]):
            for _ in range(cfg["span_syncs"]):
                step(k, False)
                k += 1
        trace = tracer.summary(SPANS)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    run_.finish(service, scene.padded["sh"].shape[1])
    n_win = len(run_.window)
    fps = cell.traffic["fps"]
    sent = [sum(run_.stats_host[j]["sync_bytes"][c] for j in run_.window) for c in range(n)]
    e2e = dict(fleet_sync_ms=H.per_item_ms(window_s, n_win),
               downlink_mbps=sum(H.mbps(x, n_win * w, fps) for x in sent) / n,
               setup_s=setup_s)
    if trace is not None:
        profiled = run_.window[:cfg["trace_syncs"]]
        stale = {j: sum(run_.stats_host[j]["resweeps"]) for j in profiled}
        H.require_counted(trace, "lod_sweep_kernel", len(k6))
        H.require_counted(trace, "vq_", len(k5))
        trace.update(spans_ms=spans.ms, kind="fleet", downlink_mbps=e2e["downlink_mbps"],
                     k6_bounds=[RF.k6(stale[j], scene.meta["S"]) for j in profiled
                                if stale[j] > 0],
                     k5_bounds=[RF.k5(int(rows), d, kc) for rows, d, kc in k5])
    del service
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    model = RF_REF.Model(scene, cfg, dev)
    diag = {}
    checks, wrong = RF_REF.compare(run_, model, torch.as_tensor(cams, device=dev),
                                   set(samples), diag)
    return dict(e2e=e2e, trace=trace, checks=checks, attempted=n_win,
                failed=len(wrong & set(run_.window)), memory_peak_bytes=peak,
                info=dict(**built, syncs=n_win, last_sync=k - 1, samples=sorted(set(samples)),
                          window_s=window_s,
                          union=[int(run_.held[j][1].n_union) for j in sorted(run_.held)],
                          gaps=diag))


def _traced(k6: list, k5: list):
    """Profiler ranges around the layers; each K6 launch counted and each
    encode's shipped rows held for K5's roofline (nothing read back inside
    the window)."""
    build, sweep = DP.build_delta_batch, SV.lod_pair_sweep

    def sweep_rec(*a, **kw):
        k6.append(a[0].shape[0])
        return sweep(*a, **kw)

    def build_rec(gaussians, codec, *a, **kw):
        batch = build(gaussians, codec, *a, **kw)
        k5.append((batch.n_shipped, codec.codebook.shape[1], codec.codebook.shape[0]))
        return batch

    return H.patched([
        (SV, "lod_pair_sweep", sweep_rec),
        (DP, "build_delta_batch", H.annotated(torch, "union_and_encode", build_rec)),
        (SV.LodService, "sync", H.annotated(torch, "sync", SV.LodService.sync)),
        (LS, "batched_top_and_staleness",
         H.annotated(torch, "top_and_staleness", LS.batched_top_and_staleness)),
        (SV, "_pooled_pair_sweep", H.annotated(torch, "pair_sweep", SV._pooled_pair_sweep)),
        (MG, "batched_cloud_sync", H.annotated(torch, "tables", MG.batched_cloud_sync))])

