"""Deadline-driven motion-to-photon scheduler for the fleet LoD service.
Port of `repro.serve.scheduler`.

`LodService.sync()` is a lockstep tick: every live client advances
together, so a fast-moving headset waits behind an idle phone. This
scheduler gives each client a frame deadline and a motion-derived priority,
and each tick syncs only the clients that need it, through the
partial-fleet mask of `LodService.sync(participate=...)`, which leaves the
others bitwise untouched.

A tick (`DeadlineScheduler.tick`):

  1. candidates: live clients with unserved motion (`observe_motion`
     queued a pose the service has not synced yet);
  2. each candidate is scored: staleness_ms (since its last sync),
     priority = staleness_ms · (1 + velocity) (velocity: an EWMA of
     |Δcam|/Δt), slack_ms = deadline_ms − age of its oldest unserved pose −
     predicted cost; candidates sort earliest deadline first (least slack),
     priority breaking ties;
  3. the selection is budgeted by predicted sync cost: cost_ms = α +
     β·stale_pairs, refit online from measured ticks, each candidate priced
     by `lod_search.predicted_stale_counts` (read-only); candidates are
     taken greedily until `tick_budget_ms` is spent, the most urgent always;
  4. one partial sync runs, is timed to completion (on the card: a
     synchronize of the service's device), and the (stale_pairs, ms) sample
     refits the cost model. The returned stats carry the stamped `mtp_ms`
     (oldest unserved pose → sync completion) and `deadline_miss` columns
     of the served slots.

`stats_summary()` gives p50/p99 motion-to-photon ms and the deadline-miss
rate. The clock is injectable, so tests drive exact schedules. An admit is
denied (`AdmissionDenied`) when the cost model says the fleet cannot hold
the newcomer's deadline: its own cold sync over its deadline, or the
fleet's utilization Σ predicted_cost / deadline over 1. `state_dict()` is
JSON-able.

On a serving mesh of several ranks every rank ticks; rank 0's selection
and times are broadcast, so each rank syncs the same clients and its cost
model takes the same samples (the clients' own motion clocks stay each
rank's).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import lod_search as ls
from repro_torch.serve.lod_service import AdmissionDenied, LodService, ServiceStats
from repro_torch.sharding import fleet as shd

DEFAULT_DEADLINE_MS = 33.0  # ~30 Hz pose-to-update budget


class CostModel:
    """Per-tick sync cost model: cost_ms = alpha + beta * stale_pairs.

    `alpha` is the fixed per-tick overhead (dispatch, table update, encode
    tail), `beta` the marginal cost of one pooled (client, slab) pair
    sweep. Seeded with pessimistic defaults and refit by least squares over
    a rolling window of measured ticks once the window holds enough spread
    (>= `min_samples` samples with pair variance) — until then predictions
    come from the seed, so admission control works from the first tick."""

    def __init__(self, alpha_ms: float = 2.0, beta_ms: float = 0.02,
                 window: int = 128, min_samples: int = 8):
        self.alpha = float(alpha_ms)
        self.beta = float(beta_ms)
        self.min_samples = int(min_samples)
        self.samples: deque = deque(maxlen=int(window))

    def predict(self, stale_pairs) -> float:
        return float(self.alpha + self.beta * max(float(stale_pairs), 0.0))

    def observe(self, stale_pairs: float, measured_ms: float) -> None:
        """Record one measured tick and refit when the window has signal
        (beta needs pair-count spread; a constant-pairs window only
        re-estimates alpha)."""
        self.samples.append((float(stale_pairs), float(measured_ms)))
        if len(self.samples) < self.min_samples:
            return
        x = np.array([s[0] for s in self.samples], np.float64)
        y = np.array([s[1] for s in self.samples], np.float64)
        if np.ptp(x) > 0.0:
            a = np.stack([np.ones_like(x), x], axis=1)
            coef, *_ = np.linalg.lstsq(a, y, rcond=None)
            alpha, beta = float(coef[0]), float(coef[1])
        else:
            alpha, beta = float(y.mean()), self.beta
        # a degenerate fit (negative marginal cost / overhead) falls back
        # to the seed rather than predicting free work
        self.alpha = max(alpha, 0.0)
        self.beta = max(beta, 0.0)

    def state_dict(self) -> Dict[str, Any]:
        return {"alpha": self.alpha, "beta": self.beta,
                "samples": [list(s) for s in self.samples]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.alpha = float(state["alpha"])
        self.beta = float(state["beta"])
        self.samples.clear()
        self.samples.extend((float(p), float(m))
                            for p, m in state.get("samples", []))


@dataclasses.dataclass
class _ClientSched:
    """Per-client scheduling state (host-side, keyed by stable id)."""

    deadline_ms: float
    last_cam: np.ndarray                      # last OBSERVED head pose
    velocity: float = 0.0                     # EWMA |Δcam|/Δt (units/s)
    last_sync_at: Optional[float] = None      # completion of last sync
    oldest_motion_at: Optional[float] = None  # oldest unserved pose time
    last_motion_at: Optional[float] = None
    pending_cam: Optional[np.ndarray] = None  # pose awaiting a sync
    ewma_pairs: float = 0.0                   # EWMA stale pairs per sync


class DeadlineScheduler:
    """Deadline/priority scheduler over a live `LodService` (see module
    docstring). `clock` is any zero-arg monotonic-seconds callable
    (default `time.monotonic`); tests inject a scripted one.
    `tick_budget_ms=None` removes the per-tick cost budget (pure EDF)."""

    VELOCITY_SMOOTHING = 0.3
    PAIRS_SMOOTHING = 0.3

    def __init__(self, service: LodService, *,
                 default_deadline_ms: float = DEFAULT_DEADLINE_MS,
                 tick_budget_ms: Optional[float] = None,
                 cost_model: Optional[CostModel] = None,
                 clock=None, window: int = 1024):
        self.service = service
        self.default_deadline_ms = float(default_deadline_ms)
        self.tick_budget_ms = (None if tick_budget_ms is None
                               else float(tick_budget_ms))
        self.cost = CostModel() if cost_model is None else cost_model
        self._clock = time.monotonic if clock is None else clock
        self._clients: Dict[int, _ClientSched] = {}
        # rolling (mtp_ms, missed) samples across the fleet
        self._mtp_samples: deque = deque(maxlen=int(window))
        self._ns = int(service.tree.meta.Ns)
        for cid in service.active_ids:
            self._register(cid, None)

    # -- client registry ------------------------------------------------------

    def _register(self, client_id: int, deadline_ms: Optional[float]):
        slot = self.service._slot_of(client_id)
        self._clients[int(client_id)] = _ClientSched(
            deadline_ms=(self.default_deadline_ms if deadline_ms is None
                         else float(deadline_ms)),
            last_cam=np.array(self.service._slot_cams[slot], np.float32),
            ewma_pairs=float(self._ns))  # pessimistic: cold ⇒ full resweep

    def set_deadline(self, client_id: int, deadline_ms: float) -> None:
        self._clients[int(client_id)].deadline_ms = float(deadline_ms)

    def deadline(self, client_id: int) -> float:
        return self._clients[int(client_id)].deadline_ms

    def forget(self, client_id: int) -> None:
        """Drop a client's scheduling state (pair with `service.evict`)."""
        self._clients.pop(int(client_id), None)

    def evict(self, client_id: int) -> None:
        self.service.evict(client_id)
        self.forget(client_id)

    # -- admission ------------------------------------------------------------

    def predicted_admission_denial(self, deadline_ms: Optional[float] = None
                                   ) -> Optional[str]:
        """Why the next admit must be refused on PREDICTED cost (None =
        admissible). Checked before any state mutation. Two gates:

          * the newcomer's own cold sync — a full Ns-slab resweep — is
            predicted over its deadline (no schedule can serve it);
          * aggregate utilization: Σ predict(ewma_pairs)/deadline over the
            fleet (newcomer included, cold) would exceed 1 — the fleet's
            steady-state demand outruns one sync lane."""
        d = (self.default_deadline_ms if deadline_ms is None
             else float(deadline_ms))
        if d <= 0:
            return f"deadline {d}ms is not positive"
        cold = self.cost.predict(self._ns)
        if cold > d:
            return (f"cold first sync predicted {cold:.2f}ms > deadline "
                    f"{d:.2f}ms")
        util = self.cost.predict(self._ns) / d
        for c in self._clients.values():
            util += self.cost.predict(c.ewma_pairs) / c.deadline_ms
        if util > 1.0:
            return (f"predicted fleet utilization {util:.2f} > 1 with the "
                    f"new client")
        return None

    def admit(self, cam=None, tau: Optional[float] = None,
              deadline_ms: Optional[float] = None, bandwidth=None,
              required: bool = True) -> Optional[int]:
        """`LodService.admit` behind the predicted-cost gate: a client whose
        deadline the cost model says cannot be held is DENIED
        (`AdmissionDenied`, or None with `required=False`) and the service
        is left untouched."""
        denial = self.predicted_admission_denial(deadline_ms)
        if denial is not None:
            if required:
                raise AdmissionDenied(denial)
            return None
        cid = self.service.admit(cam=cam, tau=tau, required=required,
                                 bandwidth=bandwidth)
        if cid is not None:
            self._register(cid, deadline_ms)
            # a new client's first pose is unserved motion: schedule it
            c = self._clients[cid]
            now = self._clock()
            c.pending_cam = c.last_cam.copy()
            c.oldest_motion_at = c.last_motion_at = now
        return cid

    # -- motion ingest --------------------------------------------------------

    def observe_motion(self, client_id: int, cam, t: Optional[float] = None
                       ) -> None:
        """Queue a new head pose for `client_id`. The pose is NOT pushed to
        the service here — it ships with the sync that serves it, so a
        never-selected client's service-side camera stays exactly what its
        last sync used. Velocity is an EWMA of |Δcam|/Δt over observed
        poses."""
        c = self._clients[int(client_id)]
        now = self._clock() if t is None else float(t)
        cam = np.asarray(cam, np.float32)
        if c.last_motion_at is not None and now > c.last_motion_at:
            inst = float(np.linalg.norm(cam - c.last_cam)
                         / (now - c.last_motion_at))
            s = self.VELOCITY_SMOOTHING
            c.velocity = (1 - s) * c.velocity + s * inst
        if c.oldest_motion_at is None:
            c.oldest_motion_at = now
        c.last_motion_at = now
        c.last_cam = cam
        c.pending_cam = cam

    # -- the tick -------------------------------------------------------------

    def _predicted_pairs(self) -> Dict[int, int]:
        """Read-only staleness preview: how many slab subtrees each LIVE
        client would resweep if synced right now, priced per candidate
        against its PENDING pose (`lod_search.predicted_stale_counts` — no
        state is touched). One device round-trip per tick."""
        svc = self.service
        cams = np.array(svc._slot_cams, np.float32)
        for cid, c in self._clients.items():
            if c.pending_cam is not None:
                cams[svc._slot_of(cid)] = c.pending_cam
        taus = (svc.taus if svc.taus is not None
                else np.full(svc.capacity, svc.cfg.tau, np.float32))
        lo, hi = svc.slot_block()
        counts = svc.gather_slots(ls.predicted_stale_counts(
            svc.tree, svc.state.temporal, cams[lo:hi], svc.focal, taus[lo:hi],
            svc.state.fleet.active)).cpu().numpy()
        return {cid: int(counts[svc._slot_of(cid)])
                for cid in self._clients}

    def select(self, now: Optional[float] = None) -> List[int]:
        """The tick's selection, without running it: EDF over clients with
        unserved motion, greedily budgeted by predicted cost."""
        now = self._clock() if now is None else float(now)
        cands = [cid for cid, c in self._clients.items()
                 if c.pending_cam is not None]
        if not cands:
            return []
        pairs = self._predicted_pairs()

        def urgency(cid):
            c = self._clients[cid]
            staleness_ms = (0.0 if c.last_sync_at is None
                            else (now - c.last_sync_at) * 1e3)
            priority = staleness_ms * (1.0 + c.velocity)
            age_ms = (now - c.oldest_motion_at) * 1e3
            slack = c.deadline_ms - age_ms - self.cost.predict(pairs[cid])
            return (slack, -priority)

        cands.sort(key=urgency)
        if self.tick_budget_ms is None:
            return cands
        selected, spent = [], self.cost.alpha
        for cid in cands:
            marginal = self.cost.beta * pairs[cid]
            if selected and spent + marginal > self.tick_budget_ms:
                continue
            selected.append(cid)
            spent += marginal
        return selected

    def tick(self, now: Optional[float] = None) -> Optional[ServiceStats]:
        """Run one scheduler tick: select, partial-sync, time, refit the
        cost model, stamp MTP columns. Returns the stamped per-slot stats,
        or None when no client had unserved motion (nothing to do — an
        idle fleet costs nothing)."""
        svc = self.service
        # under a mesh of several ranks, rank 0's clock decides for all:
        # its selection and its times, so every rank's control plane agrees
        shared = svc.mesh is not None and dist.get_world_size() > 1
        selected = self.select(now)
        if shared:
            selected = shd.broadcast_object(selected)
        if not selected:
            return None
        cams = {cid: self._clients[cid].pending_cam for cid in selected}
        t0 = self._clock()
        stats = svc.sync(cams, participate=selected)
        if stats.sync_bytes.is_cuda:
            torch.cuda.synchronize(stats.sync_bytes.device)
        t_done = self._clock()
        if shared:
            t0, t_done = shd.broadcast_object((t0, t_done))
        resweeps = svc.gather_slots(stats.resweeps).cpu().numpy()
        self.cost.observe(float(resweeps.sum()), (t_done - t0) * 1e3)
        mtp_col = np.zeros(svc.capacity, np.float32)
        miss_col = np.zeros(svc.capacity, bool)
        for cid in selected:
            c = self._clients[cid]
            slot = svc._slot_of(cid)
            s = self.PAIRS_SMOOTHING
            c.ewma_pairs = ((1 - s) * c.ewma_pairs
                            + s * float(resweeps[slot]))
            mtp = (t_done - c.oldest_motion_at) * 1e3
            missed = mtp > c.deadline_ms
            mtp_col[slot] = mtp
            miss_col[slot] = missed
            self._mtp_samples.append((mtp, missed))
            c.last_sync_at = t_done
            c.oldest_motion_at = None
            c.pending_cam = None
        dev = stats.mtp_ms.device
        lo, hi = svc.slot_block()
        return dataclasses.replace(stats, mtp_ms=torch.from_numpy(mtp_col[lo:hi]).to(dev),
                                   deadline_miss=torch.from_numpy(miss_col[lo:hi]).to(dev))

    # -- accounting -----------------------------------------------------------

    def stats_summary(self) -> Dict[str, float]:
        """Reduce the rolling MTP window: p50/p99 motion-to-photon ms and
        the deadline-miss rate (fraction of served motion samples that
        overran their client's deadline)."""
        if not self._mtp_samples:
            return {"n": 0, "mtp_p50_ms": 0.0, "mtp_p99_ms": 0.0,
                    "deadline_miss_rate": 0.0}
        mtp = np.array([s[0] for s in self._mtp_samples], np.float64)
        miss = np.array([s[1] for s in self._mtp_samples], bool)
        return {"n": int(mtp.size),
                "mtp_p50_ms": float(np.percentile(mtp, 50)),
                "mtp_p99_ms": float(np.percentile(mtp, 99)),
                "deadline_miss_rate": float(miss.mean())}

    # -- persistence ----------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """JSON-able scheduler state (the reference carries it in its
        service snapshots). Wall-clock anchors (last_sync_at /
        oldest_motion_at) are process-relative and not saved: a restored
        scheduler restarts its clock; deadlines, velocities, the fitted cost
        model and the per-client pair EWMAs survive."""
        return {
            "default_deadline_ms": self.default_deadline_ms,
            "tick_budget_ms": self.tick_budget_ms,
            "cost": self.cost.state_dict(),
            "clients": {
                str(cid): {
                    "deadline_ms": c.deadline_ms,
                    "velocity": c.velocity,
                    "ewma_pairs": c.ewma_pairs,
                    "last_cam": [float(x) for x in c.last_cam],
                } for cid, c in self._clients.items()},
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore `state_dict()` output onto a scheduler built around the
        restored service (ids must match the service's live fleet)."""
        self.default_deadline_ms = float(state["default_deadline_ms"])
        self.tick_budget_ms = (None if state["tick_budget_ms"] is None
                               else float(state["tick_budget_ms"]))
        self.cost.load_state_dict(state["cost"])
        for cid_s, cs in state.get("clients", {}).items():
            cid = int(cid_s)
            if cid not in self._clients:
                self._register(cid, cs["deadline_ms"])
            c = self._clients[cid]
            c.deadline_ms = float(cs["deadline_ms"])
            c.velocity = float(cs["velocity"])
            c.ewma_pairs = float(cs["ewma_pairs"])
            c.last_cam = np.asarray(cs["last_cam"], np.float32)


# ---------------------------------------------------------------------------
# workload generators (benchmarks + tests)
# ---------------------------------------------------------------------------


def poisson_arrivals(rng: np.random.Generator, rate: float, n_ticks: int
                     ) -> np.ndarray:
    """(n_ticks,) int — client arrivals per tick, Poisson(rate)."""
    return rng.poisson(float(rate), int(n_ticks)).astype(np.int64)


def bursty_motion_path(rng: np.random.Generator, n_steps: int, *,
                       speed: float = 0.5, burst_prob: float = 0.1,
                       burst_scale: float = 10.0,
                       start=None) -> np.ndarray:
    """(n_steps, 3) head trajectory: a random walk of per-step `speed`,
    with probability `burst_prob` per step of a `burst_scale`× saccade —
    the bursty-head-motion regime where motion-derived priority matters."""
    pos = (np.zeros(3, np.float32) if start is None
           else np.asarray(start, np.float32))
    out = np.empty((int(n_steps), 3), np.float32)
    for t in range(int(n_steps)):
        step = rng.normal(size=3).astype(np.float32)
        norm = float(np.linalg.norm(step)) or 1.0
        scale = speed * (burst_scale if rng.random() < burst_prob else 1.0)
        pos = pos + step * (scale / norm)
        out[t] = pos
    return out


def straggler_path(rng: np.random.Generator, n_steps: int, *,
                   teleport_every: int = 8, extent: float = 30.0,
                   start=None) -> np.ndarray:
    """(n_steps, 3) straggler trajectory: mostly stationary, but every
    ~`teleport_every` steps it TELEPORTS somewhere uniform in ±extent —
    each teleport forces a near-full slab resweep, the expensive client
    that makes lockstep p99 collapse."""
    pos = (rng.uniform(-extent, extent, 3).astype(np.float32)
           if start is None else np.asarray(start, np.float32))
    out = np.empty((int(n_steps), 3), np.float32)
    for t in range(int(n_steps)):
        if rng.random() < 1.0 / max(int(teleport_every), 1):
            pos = rng.uniform(-extent, extent, 3).astype(np.float32)
        out[t] = pos
    return out
