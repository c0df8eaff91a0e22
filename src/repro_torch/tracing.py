"""Spans and counters inside the port: where a frame's and a fleet sync's
time goes, measured where the work happens. Off by default.

Turning it on and reading it:

    from repro_torch import tracing
    tracing.enable()
    ... session.step(rig) / service.sync(cams) ...
    tracing.disable()
    out = tracing.drain()   # {"spans", "counters", "clock"}; everything reset

`enable()` and `disable()` may be called at any time; a span open when
tracing turns off still records its end. `drain()` reads each device
counter back (one host read) and starts over, on or off.

Spans. `with tracing.span(name):` records the name, its start and end from
`time.time_ns()`, the index (in the drained list) of the span open around
it, and the step id that `tracing.step(kind, index)` set last: every span
of frame f carries ("frame", f), every span of the fleet's k-th sync
("sync", k). A span is a host interval: it ends when the host leaves the
block, not when the device finishes the work the block enqueued. A drained
span is a dict with `name`, `start_ns`, `end_ns`, `parent` and `step`. The
spans, at layer boundaries only (never per slot or per tree level):

    frame                        CollaborativeSession.step
      cloud_sync                 pipeline.cloud_sync_step (synced frames)
        lod_search               the temporal LoD search
        manager                  cut mask, management-table sync, Δ payload ids
        encode                   Δ rows encoded and decoded (raw rows uncompressed)
        client_update            client mirror, store scatter, render queue
      frame_stats                FrameStats read back to the host
      client_render              pipeline.client_render_step
        project                  render.stages.project (K3, depth ranks)
        bin_shared               render.stages.bin_shared
          bin.expand             binning.bin_tiles up to the sort: on the card
                                 the chain's spans, count and emit passes and
                                 its one read (the kept total); on the CPU
                                 the budget-wide expansion and cull
          bin.sort               the card: one stable radix sort of the kept
                                 pairs by tile; the CPU: the two stable
                                 argsorts, gathers by the order
          bin.lists              the lists, tile counts and overflow flag
        stereo_merge             render.stages.stereo_merge (K4)
        rasterize                render.stages.rasterize (K2, both eyes)
        stereo_stats             core.stereo.alpha_skip_stats
    sync                         LodService.sync
      top_and_staleness          every slot's top sweep and staleness test
      pair_sweep                 stale count, pair compaction, K6, scatter back
      tables                     table sync and render queues (_finish_sync)
      union_and_encode           delta_path.build_delta_batch (pooled dedup)

`bin.*` spans open wherever `bin_tiles` runs (the fleet's fallback render
too), under whatever span is open there.

Counters. `tracing.count(name, value)` adds a host int on the host, and a
device tensor into a device int64 with one launch and no host read:

    bin.pairs_needed     Σ of the (splat, tile) pairs the frame's splats
                         cover before the precise cull (device)
    bin.pair_budget      Σ of the pair budget `max_pairs` (host), so that
                         needed / budget reads the same on both paths
    bin.pairs_sorted     Σ of the pairs bin_tiles' sort took (host): on
                         the card the kept pairs, after the budget and the
                         precise cull, whose count the chain reads anyway;
                         on the CPU the whole budget `max_pairs`. Before the
                         card's chain it was the budget on both paths.

Cost. Off, `span` returns one shared no-op object and `count` and `step`
return at once: one global test per call, no allocation, no clock read, no
device work. On, a span costs two clock reads and a list append on the
host, and a device count one small kernel (a fill more on its first).

Clock. `time.time_ns()` is CLOCK_REALTIME, the clock torch.profiler stamps
its events with: an event's absolute time is
`prof.profiler.kineto_results.trace_start_ns()` plus its offset (its
`start_ns()` as a Kineto event). The spans are not profiler ranges, so they
add no event to a device trace.

One thread drives the port; the recorder is process-wide, as the profiler
is."""

from __future__ import annotations

import time

import torch

CLOCK = "CLOCK_REALTIME ns"


class _Off:
    """The span handed out while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    def __init__(self):
        self.spans = []           # [name, start_ns, end_ns, parent, step]
        self.open = []            # indices of the spans open, innermost last
        self.step = None
        self.host = {}
        self.device = {}


class _Span:
    __slots__ = ("rec", "name", "row")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        self.row = [self.name, 0, None, rec.open[-1] if rec.open else None, rec.step]
        rec.open.append(len(rec.spans))
        rec.spans.append(self.row)
        self.row[1] = time.time_ns()
        return None

    def __exit__(self, *exc):
        self.row[2] = time.time_ns()
        self.rec.open.pop()
        return False


_rec = _Recorder()
_on = False


def enable() -> None:
    """Record spans and counters from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until `drain`."""
    global _on
    _on = False


def span(name: str):
    """A context manager recording one span (a no-op while off)."""
    if not _on:
        return _OFF
    return _Span(_rec, name)


def step(kind: str, index: int) -> None:
    """Set the step id the next spans carry: ("frame", f), ("sync", k)."""
    if _on:
        _rec.step = (kind, int(index))


def count(name: str, value) -> None:
    """Add `value` to counter `name`: a host int on the host, a device
    tensor on its device without a host read."""
    if not _on:
        return
    if isinstance(value, torch.Tensor):
        key = (name, value.device)
        acc = _rec.device.get(key)
        if acc is None:
            acc = _rec.device[key] = torch.zeros((), dtype=torch.int64, device=value.device)
        acc.add_(value.detach())
    else:
        _rec.host[name] = _rec.host.get(name, 0) + int(value)


def drain() -> dict:
    """Everything recorded since the last drain, and a fresh start:
    {"spans": [{"name", "start_ns", "end_ns", "parent", "step"}, ...],
    "counters": {name: int}, "clock": CLOCK}. Each device counter is read
    back here, once."""
    global _rec
    rec, _rec = _rec, _Recorder()
    counters = dict(rec.host)
    for (name, _dev), acc in rec.device.items():
        counters[name] = counters.get(name, 0) + int(acc)
    spans = [dict(name=n, start_ns=s, end_ns=e, parent=p,
                  step=None if st is None else list(st))
             for n, s, e, p, st in rec.spans]
    return dict(spans=spans, counters=counters, clock=CLOCK)
