"""The program's own spans (`repro_torch.tracing`) laid over a
torch.profiler profile of the same stretch.

Both sides stamp CLOCK_REALTIME nanoseconds: a drained span its
`time.time_ns()`, a profiler event its Kineto `start_ns()`
(`prof.profiler.kineto_results.trace_start_ns()` plus the event's offset).
So a span holds the runtime calls the host made inside it, and each launch
leads, by Kineto's correlation id, to the device work it started.

    events = read_profile(prof)          # the profile as plain tuples
    program = attribute(tracing.drain(), events)

`attribute` gives each program span in the profiled window:
  host_ms     its host time;
  launches    the kernel and memcpy/memset launches (runtime calls) that
              began inside it, its child spans' included;
  syncs       the blocking calls that began inside it (stream, device and
              event synchronizes, and the synchronous cudaMemcpy, which
              counts as a launch too);
  device_ms   the device time of the work those launches started, or None
              where a launch has no device event (the profiler lost it);
and the window's device-idle gaps, each given to the innermost program
span open when it began ("outside program spans" where none was).
`per_step` turns those into a per-frame or per-sync figure for a metric."""

from __future__ import annotations

from bisect import bisect_left

import torch

LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy",
                   "cuMemset")
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                   "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize",
                   "cuEventSynchronize"))
OUTSIDE = "outside program spans"


def read_profile(prof) -> dict:
    """A finished torch.profiler profile as {"launches": [(start_ns, corr)],
    "syncs": [start_ns], "device": [(start_ns, end_ns, corr)], "window":
    (start_ns, end_ns) of the host range named "window", or None}."""
    cuda = torch.autograd.DeviceType.CUDA
    launches, syncs, device, window = [], [], [], None
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == cuda:
            # kernels, copies and fills; not the device copies of host ranges
            if not e.is_user_annotation():
                device.append((start, end, e.correlation_id()))
            continue
        if name == "window":
            window = (start, end)
        if name.startswith(LAUNCH_PREFIXES):
            launches.append((start, e.correlation_id()))
        if name in SYNCS:
            syncs.append(start)
    return dict(launches=sorted(launches), syncs=sorted(syncs), device=device,
                window=window)


def attribute(drained: dict, events: dict) -> dict:
    """Each drained span in the window with its host ms, launches, syncs
    and device ms; the counters; the window's idle seconds by program span."""
    w = events.get("window")
    spans = [s for s in drained["spans"] if s["end_ns"] is not None
             and (w is None or w[0] <= s["start_ns"] <= w[1])]
    l_start = [t for t, _ in events["launches"]]
    syncs = events["syncs"]
    dev_ms = {}
    for s, e, corr in events["device"]:
        dev_ms[corr] = dev_ms.get(corr, 0.0) + (e - s) / 1e6
    out = []
    for s in spans:
        lo, hi = bisect_left(l_start, s["start_ns"]), bisect_left(l_start, s["end_ns"])
        corrs = [c for _, c in events["launches"][lo:hi]]
        device = (sum(dev_ms[c] for c in corrs) if all(c in dev_ms for c in corrs)
                  else None)
        blocking = bisect_left(syncs, s["end_ns"]) - bisect_left(syncs, s["start_ns"])
        out.append(dict(name=s["name"], step=s["step"],
                        host_ms=(s["end_ns"] - s["start_ns"]) / 1e6, launches=hi - lo,
                        syncs=blocking, device_ms=device))
    idle, idle_s = _idle_by_span(spans, events["device"], w)
    return dict(spans=out, counters=dict(drained["counters"]),
                idle=sorted(idle.items(), key=lambda kv: -kv[1]), idle_s=idle_s,
                idle_in_spans_s=idle_s - idle.get(OUTSIDE, 0.0))


def _idle_by_span(spans, device, window):
    """Seconds of each device-idle gap of the window by the innermost
    program span open at the gap's start."""
    if window is None:
        if not spans:
            return {}, 0.0
        window = (min(s["start_ns"] for s in spans), max(s["end_ns"] for s in spans))
    w0, w1 = window
    busy = sorted((max(s, w0), min(e, w1)) for s, e, _ in device if e > w0 and s < w1)
    gaps, cur = [], w0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < w1:
        gaps.append((cur, w1))
    # one thread's spans nest, so those open at a gap's start form a stack
    host = sorted(spans, key=lambda s: s["start_ns"])
    idle, stack, j = {}, [], 0
    for gs, ge in gaps:
        while j < len(host) and host[j]["start_ns"] <= gs:
            while stack and stack[-1]["end_ns"] <= host[j]["start_ns"]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1]["end_ns"] <= gs:
            stack.pop()
        inner = stack[-1]["name"] if stack else OUTSIDE
        idle[inner] = idle.get(inner, 0.0) + (ge - gs) / 1e9
    return idle, sum(idle.values())


def per_step(trace: dict, step: str, name: str, field: str):
    """Σ `field` over the spans named `name` per span named `step` (a frame
    or a sync) of `trace["program"]`; None where there is none of either or
    a value is missing."""
    spans = (trace.get("program") or {}).get("spans") or []
    steps = sum(1 for s in spans if s["name"] == step)
    values = [s[field] for s in spans if s["name"] == name]
    if not steps or not values or any(v is None for v in values):
        return None
    return sum(values) / steps
