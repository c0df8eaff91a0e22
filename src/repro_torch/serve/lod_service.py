"""Batched multi-client LoD service — the cloud half of paper Fig. 9/10 for B
headsets on one shared city tree. Port of `repro.serve.lod_service`: the
functional core and the ragged-fleet `LodService`.

  * one `LodTree` and one scene codec serve every client;
  * per-client state (`TemporalState`, `ManagerState`, sync counters, page
    debt) is stacked on a leading slot axis (`ServiceState`);
  * `service_sync_vmapped` runs each client's temporal LoD search (K1 per
    client on the card): the exactness reference;
  * `service_sync_pooled` is the production scheduler: the cheap top-tree
    sweep and staleness test run per client, then the stale (client, slab)
    pairs of the whole fleet are compacted on the device into one pow2
    bucket (repeat-padded with earlier pairs) and swept by ONE K6 launch,
    each pair at its own camera and τ. The host reads two scalars per sync:
    the pool size here and the Δ-union size in the tail;
  * the sync tail is encode-once (`repro_torch.serve.delta_path`): the
    fleet-union Δcut is encoded by one codec call (K5) and fanned out as
    per-client masks, so downlink bytes and encode work grow with the
    fleet's unique Gaussians, not with B.

Both schedulers give the same bits. The fleet is ragged at run time
(`repro_torch.serve.fleet`): clients are admitted and evicted between syncs
into a pow2 slot array that grows and shrinks; inactive slots add nothing
to the wire or the stats and stay bitwise at their reset value. Around the
sync paths sit the closed-loop per-client bitrate controller
(`rate_control_step`, bandwidth tiers), the page-loss NACK path (a lost
page's rows return as debt) and partial-fleet syncs (`participate`: the
deadline scheduler's primitive, `repro_torch.serve.scheduler`), and
`snapshot` / `restore` (`repro_torch.serve.recovery`, in the reference's
format).

The service runs on a clients×slabs serving mesh (`LodService(mesh=)`,
`repro_torch.sharding.fleet`), one process a rank: each rank holds its
client shard's slots and its block of the slab tables, the pooled
staleness pool is per client shard (one all-gather of the shards' pool
sizes picks the common bucket), the Δ-union's counts reduce over
`clients` and the union's rows split over `slabs` for the encode. The
results are the meshless service's bits; `resize_mesh` moves a live
service between meshes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch import render as rnd
from repro_torch import tracing
from repro_torch.core import compression as comp
from repro_torch.core import lod_search as ls
from repro_torch.core import manager as mgr
from repro_torch.core.gaussians import Gaussians
from repro_torch.core.lod_tree import LodTree
from repro_torch.core.pipeline import SessionConfig, session_wire_format
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.lod_cut import lod_pair_sweep
from repro_torch.serve import delta_path as dp
from repro_torch.serve import fleet as flt
from repro_torch.sharding import fleet as shd


class AdmissionDenied(RuntimeError):
    """`LodService.admit` refused: the fleet's budget (client count or state
    bytes) is spent; backpressure instead of unbounded growth."""


@dataclasses.dataclass(frozen=True)
class ServiceState:
    """All per-client cloud state, on a leading (C, ...) slot axis of the
    fleet's capacity (not its live count).

    pending: (C, N) bool — Δ rows owed to the slot from earlier paged syncs
    (deferred by the stream budget or the row allowance, or NACKed), folded
    into the next sync's union until they ship; all False for a free slot.
    `fleet` records which slots hold a live client."""

    mgr: mgr.ManagerState       # leaves (C, N)
    temporal: ls.TemporalState  # leaves (C, Ns, ...)
    cut_gids: torch.Tensor      # (C, cut_budget) int32, -1 padded
    sync_index: torch.Tensor    # (C,) int32 — per-slot syncs while active
    pending: torch.Tensor       # (C, N) bool
    fleet: flt.FleetState

    @property
    def capacity(self) -> int:
        return self.sync_index.shape[0]

    @property
    def n_clients(self) -> int:
        """The slot capacity, as the reference's property (the live count
        is `fleet.active`)."""
        return self.sync_index.shape[0]


@dataclasses.dataclass(frozen=True)
class ServiceStats:
    """Per-client accounting for one service sync (all leaves (C,); an
    inactive slot's row is all zero, not even a header is charged)."""

    cut_size: torch.Tensor          # int32 — render-queue size
    delta_size: torch.Tensor        # int32 — Δcut Gaussians for the client
    unique_delta: torch.Tensor      # int32 — Δ rows it added to the fleet
    #                                 union as first requester
    sync_bytes: torch.Tensor        # float32 — downlink bytes
    dedup_bytes_saved: torch.Tensor  # float32 — unicast minus encode-once bytes
    nodes_touched: torch.Tensor     # int32 — LoD-search work of the client
    resweeps: torch.Tensor          # int32 — stale subtrees swept
    client_resident: torch.Tensor   # int32 — client store occupancy after sync
    overflow: torch.Tensor          # bool — cut exceeded cut_budget
    delta_overflow: torch.Tensor    # bool — a Δ row of the client was deferred
    delta_shipped: torch.Tensor     # int32 — union rows the client ingested
    delta_deferred: torch.Tensor    # int32 — rows owed to it after the sync
    pages: torch.Tensor             # int32 — priority pages it pulled from
    mtp_ms: torch.Tensor            # float32 — stamped by the deadline
    #                                 scheduler; 0 on the sync paths
    deadline_miss: torch.Tensor     # bool — likewise; False on the sync paths


def service_init(tree: LodTree, cfg: SessionConfig, n_clients: int,
                 capacity: Optional[int] = None) -> ServiceState:
    """Service state for `n_clients` live clients in a `capacity`-slot array
    (default capacity == n_clients), on the tree's device."""
    m, dev = tree.meta, tree.device
    cap = max(n_clients, 1) if capacity is None else int(capacity)
    if cap < max(n_clients, 1):
        raise ValueError(f"capacity {cap} < n_clients {n_clients}")
    return ServiceState(
        mgr=pytree.tree_map(lambda a: a.expand((cap,) + a.shape).clone(),
                            mgr.ManagerState.initial(tree.n_pad, dev)),
        temporal=ls.TemporalState.initial_batched(m.Ns, m.S, cap, dev),
        cut_gids=torch.full((cap, cfg.cut_budget), -1, dtype=torch.int32, device=dev),
        sync_index=torch.zeros((cap,), dtype=torch.int32, device=dev),
        pending=torch.zeros((cap, tree.n_pad), dtype=torch.bool, device=dev),
        fleet=flt.fleet_init(cap, n_clients, device=dev),
    )


# ---------------------------------------------------------------------------
# fleet lifecycle: slot admission / eviction / capacity growth and shrink
# ---------------------------------------------------------------------------


def _fresh_slot_leaves(state: ServiceState):
    """(ManagerState, TemporalState, cut row, sync counter, pending row) of
    one fresh slot, shaped like `state`'s."""
    n = state.mgr.client_has.shape[1]
    ns, s = state.temporal.slab_cut0.shape[1:]
    dev = state.sync_index.device
    return (mgr.ManagerState.initial(n, dev), ls.TemporalState.initial(ns, s, dev),
            torch.full((state.cut_gids.shape[1],), -1, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((n,), dtype=torch.bool, device=dev))


def _reset_slot(state: ServiceState, slot: int) -> ServiceState:
    f_mgr, f_tmp, f_cut, f_idx, f_pend = _fresh_slot_leaves(state)
    return ServiceState(
        mgr=flt.reset_slot(state.mgr, f_mgr, slot),
        temporal=flt.reset_slot(state.temporal, f_tmp, slot),
        cut_gids=flt.reset_slot(state.cut_gids, f_cut, slot),
        sync_index=flt.reset_slot(state.sync_index, f_idx, slot),
        pending=flt.reset_slot(state.pending, f_pend, slot),
        fleet=state.fleet,
    )


def service_admit_slot(state: ServiceState, slot: int, client_id: int) -> ServiceState:
    """Admit `client_id` into `slot`: every per-slot leaf back to its fresh
    value (the first sync is a cold sweep and a cold Δcut), the slot live."""
    state = _reset_slot(state, slot)
    return dataclasses.replace(state, fleet=flt.fleet_admit_slot(state.fleet, slot,
                                                                  client_id))


def service_nack_rows(state: ServiceState, slot: int, lost_rows) -> ServiceState:
    """Re-queue one slot's lost Δ rows ((N,) bool) as pending debt: they ride
    the next sync's union like budget-deferred pages. A free slot takes
    nothing (a NACK that races an eviction does not bring its debt back)."""
    lost = torch.as_tensor(lost_rows, dtype=torch.bool, device=state.pending.device)
    pending = state.pending.clone()
    pending[slot] = pending[slot] | (lost & state.fleet.active[slot])
    return dataclasses.replace(state, pending=pending)


def service_note_admit(state: ServiceState, client_id: int) -> ServiceState:
    """An admit into a slot another client shard holds, seen from this one:
    only the replicated id counter moves."""
    nid = state.fleet.next_id
    return dataclasses.replace(state, fleet=dataclasses.replace(
        state.fleet, next_id=torch.maximum(nid, torch.full_like(nid, int(client_id) + 1))))


def service_evict_slot(state: ServiceState, slot: int) -> ServiceState:
    """Evict the client in `slot`: the slot is freed and reset at once, so
    its next tenant finds it as fresh as a never-used one."""
    state = _reset_slot(state, slot)
    return dataclasses.replace(state, fleet=flt.fleet_evict_slot(state.fleet, slot))


def service_grow(tree: LodTree, cfg: SessionConfig, state: ServiceState,
                 new_capacity: int) -> ServiceState:
    """Pad every slot-axis leaf to `new_capacity` (the new slots free and
    fresh)."""
    f_mgr, f_tmp, f_cut, f_idx, f_pend = _fresh_slot_leaves(state)
    return ServiceState(
        mgr=flt.pad_slots(state.mgr, f_mgr, new_capacity),
        temporal=flt.pad_slots(state.temporal, f_tmp, new_capacity),
        cut_gids=flt.pad_slots(state.cut_gids, f_cut, new_capacity),
        sync_index=flt.pad_slots(state.sync_index, f_idx, new_capacity),
        pending=flt.pad_slots(state.pending, f_pend, new_capacity),
        fleet=flt.fleet_grow(state.fleet, new_capacity),
    )


def service_shrink(state: ServiceState, perm) -> ServiceState:
    """Compact the fleet into the `len(perm)` slots named by `perm` (live
    slots first, in slot order, then free ones): one gather a leaf.
    Survivors keep their state and their relative order, so they replay
    bitwise; the gathered free slots are fresh."""
    return ServiceState(
        mgr=flt.take_slots(state.mgr, perm),
        temporal=flt.take_slots(state.temporal, perm),
        cut_gids=flt.take_slots(state.cut_gids, perm),
        sync_index=flt.take_slots(state.sync_index, perm),
        pending=flt.take_slots(state.pending, perm),
        fleet=flt.fleet_shrink(state.fleet, perm),
    )


def _batched_cut_gids(masks: torch.Tensor, budget: int):
    """(B, budget) ascending cut ids (-1 padded) and (B,) cut sizes."""
    gids = torch.stack([ls.compact_ids(m, budget) for m in masks])
    return gids, masks.sum(1).to(torch.int32)


def _finish_sync(tree: LodTree, cfg: SessionConfig, state: ServiceState,
                 temporal: ls.TemporalState, masks: torch.Tensor,
                 nodes_touched: torch.Tensor, resweeps: torch.Tensor,
                 bytes_per_g: float, codec: Optional[comp.Codec] = None,
                 dedup: bool = False, delta_budget: Optional[int] = None,
                 priority=None, allowance=None, page_size: Optional[int] = None,
                 participate=None, mesh=None, n_shards: int = 1
                 ) -> Tuple[ServiceState, ServiceStats, Optional[dp.DeltaBatch]]:
    """Shared tail of both sync paths: the batched management-table update,
    the per-client render queues, the Δcut payload and the accounting.

    With `dedup` the wire format is the shared multicast stream of
    `delta_path` (one encode of the fleet union; `sync_bytes` splits each
    shipped row across its requesters and adds the page headers), and the
    `DeltaBatch` is returned; without it each client is charged its own
    unicast stream and the third element is None. The union folds in
    `state.pending`; the new `pending` is this sync's deferred rows minus
    those the shared reuse rule evicted meanwhile. `priority` is the (N,)
    coarse-first rank key (default: the tree's node levels); `allowance`
    the optional (C,) int32 per-client row cap (the bitrate controller's
    knob).

    Inactive slots are masked out of everything here: no cut, no table
    update, no Δ rows, 0 bytes, and their sync counter does not tick.

    `participate` ((C,) bool) makes this a partial-fleet sync: an active
    slot left out is treated like an inactive one (no table update, no
    union rows, 0 bytes, no tick), except that it keeps what it had: its
    render queue, its pending debt and (in the callers) its temporal state
    survive bitwise. None is the lockstep sync.

    Under a mesh (`n_shards` client shards) the state is this rank's block:
    everything here is slot-parallel except the Δ-union, the requester
    split of the shared rows and the first-requester counts, which reduce
    over `clients`."""
    dev = masks.device
    with tracing.span("tables"):
        eff = _effective_slots(state, participate)
        masks = masks & eff[:, None]
        new_mgr, plan = mgr.batched_cloud_sync(state.mgr, masks, state.sync_index, cfg.w_star)
        new_mgr = flt.freeze_inactive(new_mgr, state.mgr, eff)
        gids, counts = _batched_cut_gids(masks, cfg.cut_budget)
        if participate is not None:
            # a slot that sat out keeps its render queue (a free slot's is the
            # fresh -1 row already)
            gids = torch.where(eff[:, None], gids, state.cut_gids)
        unicast = mgr.batched_wire_bytes(plan, bytes_per_g, active=eff)
        batch = None
        zeros_i = torch.zeros(counts.shape, dtype=torch.int32, device=dev)
    if dedup:
        if codec is None or delta_budget is None:
            raise ValueError("dedup sync needs a codec and a delta_budget")
        if priority is None:
            priority = tree.node_levels()
        with tracing.span("union_and_encode"):
            batch = dp.build_delta_batch(tree.gaussians, codec, plan.delta_data,
                                         delta_budget, active=eff, pending=state.pending,
                                         priority=priority, allowance=allowance,
                                         page_size=page_size, mesh=mesh, n_shards=n_shards)
        share = None
        if n_shards > 1:
            cols = (batch.delivered & eff[:, None]).sum(0)
            share = shd.all_reduce(mesh, "clients", cols.to(
                shd.count_dtype(counts.shape[0] * n_shards))).to(torch.int32)
        sync_bytes = mgr.batched_wire_bytes(plan, bytes_per_g, shared_payload=True,
                                            active=eff, delivered=batch.delivered,
                                            client_pages=batch.client_pages, share=share)
        saved = unicast - sync_bytes
        delta_overflow = batch.client_overflow
        delta_shipped = batch.delivered.sum(1).to(torch.int32)
        # deferred rows stay owed until they ship, unless the shared reuse
        # rule evicted them meanwhile
        pending = batch.deferred & ~plan.evicted & eff[:, None]
        if participate is not None:
            # a slot that sat out keeps its debt (its rows were masked out
            # of this union, so `deferred` is blank for it)
            pending = torch.where(eff[:, None], pending, state.pending)
        delta_deferred = pending.sum(1).to(torch.int32)
        pages = batch.client_pages
    else:
        sync_bytes = unicast
        saved = torch.zeros_like(unicast)
        delta_overflow = torch.zeros(counts.shape, dtype=torch.bool, device=dev)
        delta_shipped = torch.where(eff, plan.n_delta, zeros_i)
        delta_deferred = zeros_i
        pages = zeros_i
        pending = state.pending
    new_state = ServiceState(mgr=new_mgr, temporal=temporal, cut_gids=gids,
                             sync_index=state.sync_index + eff.to(torch.int32),
                             pending=pending, fleet=state.fleet)
    stats = ServiceStats(
        cut_size=counts,
        delta_size=plan.n_delta,
        unique_delta=dp.first_owner_counts(plan.delta_data, mesh, n_shards),
        sync_bytes=sync_bytes,
        dedup_bytes_saved=saved,
        nodes_touched=torch.where(eff, nodes_touched.to(torch.int32), zeros_i),
        resweeps=torch.where(eff, resweeps.to(torch.int32), zeros_i),
        client_resident=plan.n_resident,
        overflow=counts > cfg.cut_budget,
        delta_overflow=delta_overflow & eff,
        delta_shipped=delta_shipped,
        delta_deferred=delta_deferred,
        pages=torch.where(eff, pages, zeros_i),
        mtp_ms=torch.zeros(counts.shape, dtype=torch.float32, device=dev),
        deadline_miss=torch.zeros(counts.shape, dtype=torch.bool, device=dev))
    return new_state, stats, batch


def _effective_slots(state: ServiceState, participate) -> torch.Tensor:
    """(C,) bool — the slots a sync serves: the live ones, less those a
    partial sync leaves out."""
    active = state.fleet.active
    if participate is None:
        return active
    return active & torch.as_tensor(np.asarray(participate, bool), device=active.device)


# ---------------------------------------------------------------------------
# closed-loop per-client bitrate control (heterogeneous bandwidth tiers)
# ---------------------------------------------------------------------------


BANDWIDTH_TIERS = {
    # downlink budgets in bytes a sync: a phone on a cellular link, a
    # standalone headset on home Wi-Fi, a tethered headset whose link is
    # never the bottleneck
    "phone": 2.5e5,
    "headset": 1.5e6,
    "tethered": 1.6e7,
}


def rate_control_step(target_bytes, measured_bytes, allowance, tau_scale, *,
                      page_size: int, max_rows: int,
                      tau_step: float = 1.25, tau_scale_max: float = 8.0):
    """One update of the per-client closed-loop bitrate controller, in numpy
    on the host, from the previous sync's measured bytes.

      * `allowance` — rows the client may ingest a sync: scaled by
        target/measured, the step clipped to [×0.5, ×2], floored at one page
        (`min(page_size, max_rows)`, so the clip bounds never invert) and
        capped at `max_rows` (the stream budget);
      * `tau_scale` — when a client at the one-page floor still overshoots,
        its foveation τ scales up by `tau_step` a sync (coarser cut, fewer
        rows), up to `tau_scale_max`; once measured < target / tau_step it
        decays back toward 1.

    `measured == 0` under a finite target is the most headroom, not "no
    signal": an idle client gets the full ×2 step and a τ relax. Clients
    with a non-finite target (or a negative allowance) pass through.
    Returns new (allowance int64, tau_scale float32) arrays."""
    target = np.asarray(target_bytes, np.float64)
    measured = np.asarray(measured_bytes, np.float64)
    allowance = np.asarray(allowance, np.int64)
    tau_scale = np.asarray(tau_scale, np.float32)
    controlled = np.isfinite(target) & (allowance >= 0)
    ratio = np.where(controlled,
                     np.where(measured > 0.0, target / np.maximum(measured, 1.0), np.inf),
                     1.0)
    step = np.clip(ratio, 0.5, 2.0)
    lo = min(int(page_size), int(max_rows))
    new_allow = np.where(controlled, np.clip(np.floor(allowance * step), lo, max_rows),
                         allowance).astype(np.int64)
    at_floor = controlled & (new_allow <= lo) & (ratio < 1.0)
    new_tau = np.where(at_floor, np.minimum(tau_scale * tau_step, tau_scale_max), tau_scale)
    relaxed = controlled & ~at_floor & (ratio > tau_step) & (tau_scale > 1.0)
    new_tau = np.where(relaxed, np.maximum(new_tau / tau_step, 1.0), new_tau)
    return new_allow, new_tau.astype(np.float32)


def _bandwidth_bytes(bw) -> float:
    """One client's byte target a sync: a `BANDWIDTH_TIERS` name, a number,
    or None (uncontrolled, inf)."""
    if bw is None:
        return float("inf")
    if isinstance(bw, str):
        try:
            return float(BANDWIDTH_TIERS[bw])
        except KeyError:
            raise ValueError(f"unknown bandwidth tier {bw!r} (have "
                             f"{sorted(BANDWIDTH_TIERS)})") from None
    return float(bw)


def _fleet_taus(cfg: SessionConfig, n_clients: int, taus, device) -> torch.Tensor:
    """(B,) per-client LoD thresholds: cfg.tau everywhere unless a foveated
    per-client vector is given."""
    if taus is None:
        return torch.full((n_clients,), cfg.tau, dtype=torch.float32, device=device)
    taus = torch.as_tensor(taus, dtype=torch.float32, device=device)
    if tuple(taus.shape) != (n_clients,):
        raise ValueError(f"expected ({n_clients},) taus, got {tuple(taus.shape)}")
    return taus


def service_sync_vmapped(tree: LodTree, cfg: SessionConfig, state: ServiceState,
                         cam_positions, focal: float, bytes_per_g: float, taus=None,
                         codec: Optional[comp.Codec] = None, dedup: bool = False,
                         delta_budget: Optional[int] = None, priority=None,
                         allowance=None, page_size: Optional[int] = None,
                         participate=None, mesh=None, n_shards: int = 1
                         ) -> Tuple[ServiceState, ServiceStats, Optional[dp.DeltaBatch]]:
    """One LoD sync for every client, each slot's full temporal search in
    turn (K1 per slot on the card): the exactness reference of the pooled
    scheduler. Inactive slots, and active ones that sit out a partial sync
    (`participate`), get their temporal state back afterwards, so the state
    equals the pooled scheduler's bit for bit.

    Under a mesh each rank searches its own client shard's slots (every
    per-slot argument is its block) over the whole tree, which every rank
    holds; the `slabs` ranks of one client shard repeat that work."""
    cams = torch.as_tensor(cam_positions, dtype=torch.float32, device=tree.device)
    tau_b = _fleet_taus(cfg, cams.shape[0], taus, tree.device)
    eff = _effective_slots(state, participate)
    cut, temporal = ls.batched_temporal_search(tree, state.temporal, cams, focal, tau_b)
    temporal = flt.freeze_inactive(temporal, state.temporal, eff)
    masks = ls.batched_cut_mask(cut, tree)
    return _finish_sync(tree, cfg, state, temporal, masks, cut.nodes_touched,
                        cut.resweep.sum(1), bytes_per_g, codec=codec, dedup=dedup,
                        delta_budget=delta_budget, priority=priority,
                        allowance=allowance, page_size=page_size,
                        participate=participate, mesh=mesh, n_shards=n_shards)


def _apply_pooled_updates(slab_cut, root_expand, rho, cam0, sel_b, sel_s, f_cut,
                          f_rexp, f_rho, cam_sel, guard: bool = False):
    """Scatter pooled sweep results into (copies of) the batched temporal
    state. Repeat-padded pairs write identical values.

    `guard` (a client shard with no stale pair, whose bucket is padded with
    its first slot at slab 0): every lane rewrites that pair's current
    values, so the shard's scatter changes nothing."""
    at = (sel_b, sel_s)
    if guard:
        f_cut, f_rexp, f_rho, cam_sel = (slab_cut[at], root_expand[at], rho[at],
                                         cam0[at])
    return (slab_cut.index_put(at, f_cut), root_expand.index_put(at, f_rexp),
            rho.index_put(at, f_rho), cam0.index_put(at, cam_sel))


def _compact_stale_pairs(stale: torch.Tensor, bucket: int):
    """The (B, Ns) staleness mask compacted on the device into a `bucket` of
    (client, slab) indices, repeat-padded with the earlier stale pairs
    (index i mod count, the cycle of `np.resize`). Returns (sel_b, sel_s)."""
    ns = stale.shape[1]
    (idx,) = torch.nonzero(stale.reshape(-1), as_tuple=True)
    sel = idx[torch.arange(bucket, device=idx.device) % max(idx.numel(), 1)]
    return sel // ns, sel % ns


def _pooled_pair_sweep(tables: ls.SlabTables, rpe, cams, taus, sel_b, sel_s,
                       focal: float, *, max_depth: int, mesh=None, slab_blocks: int = 1):
    """Gather the pooled pairs' slab attributes from the resident tables and
    sweep them in one K6 launch (its plain version on CPU tensors).

    With the tables in `slab_blocks` blocks over the mesh's `slabs` axis,
    the ranks of that axis share one client block and so hold the same
    pairs. Each sweeps every pair on the rows of its own block (a pair whose
    slab another rank owns takes some row of this block, and its result is
    dropped), an all-gather over `slabs` brings every rank's results, and
    each pair keeps those of the rank that owns its slab: a select, so the
    bits are the whole tables'. K6's results are 1.5 KB a pair against the
    39 KB of its inputs, so they are what travels."""
    cols = (tables.mu, tables.size, tables.parent, tables.level, tables.is_leaf,
            tables.valid)
    if slab_blocks <= 1:
        return lod_pair_sweep(*(c[sel_s] for c in cols), rpe[sel_b, sel_s], cams[sel_b],
                              focal, taus[sel_b], max_depth=max_depth)
    per = tables.mu.shape[0]
    mine = (sel_s - mesh.index("slabs") * per).clamp(0, per - 1)
    out = lod_pair_sweep(*(c[mine] for c in cols), rpe[sel_b, sel_s], cams[sel_b], focal,
                         taus[sel_b], max_depth=max_depth)
    lane = torch.arange(sel_s.shape[0], device=sel_s.device)
    owner = sel_s // per
    return tuple(e[owner, lane] for e in shd.all_gather_blocks(mesh, "slabs", list(out)))


def service_sync_pooled(tree: LodTree, cfg: SessionConfig, state: ServiceState,
                        cam_positions, focal: float, bytes_per_g: float, taus=None,
                        codec: Optional[comp.Codec] = None, dedup: bool = False,
                        delta_budget: Optional[int] = None, priority=None,
                        allowance=None, page_size: Optional[int] = None,
                        participate=None, tables: Optional[ls.SlabTables] = None,
                        mesh=None, n_shards: int = 1
                        ) -> Tuple[ServiceState, ServiceStats, Optional[dp.DeltaBatch]]:
    """One LoD sync for every client with cross-client slab pooling.

    The top sweep and staleness test run per client; the stale (client,
    slab) pairs of the fleet are compacted on the device into one pow2
    bucket and swept in one K6 launch, each pair with its own camera and τ,
    then scattered back. The same bits as `service_sync_vmapped`. The host
    reads the pool size (and, with dedup, the Δ-union size) and nothing
    else. Inactive slots report no staleness, so they never enter the pool;
    on a partial sync (`participate`) neither do the slots that sit out, and
    their temporal state, render queue, debt and counter survive bitwise.
    `tables` are the resident slab tables (`SlabTables.from_tree`).

    Under a mesh (`n_shards` client shards; every per-slot argument is this
    rank's block) the pool is per client shard: the shards' pool sizes are
    all-gathered over `clients` (the one host read), so every shard picks
    the same pow2 bucket of its own pairs; a shard with none pads its
    bucket with a guarded no-op pair. The slab rows come from the `slabs`
    blocks of the tables."""
    m = tree.meta
    cams = torch.as_tensor(cam_positions, dtype=torch.float32, device=tree.device)
    tau_b = _fleet_taus(cfg, cams.shape[0], taus, tree.device)
    eff = _effective_slots(state, participate)
    if tables is None:
        tables = ls.SlabTables.from_tree(tree, mesh=mesh)
    with tracing.span("top_and_staleness"):
        top_cut, rpe, stale = ls.batched_top_and_staleness(tree, state.temporal, cams,
                                                           focal, tau_b, eff)
    with tracing.span("pair_sweep"):
        if n_shards > 1:
            shard_counts = shd.all_gather_blocks(
                mesh, "clients", [stale.sum().to(torch.int32)])[0].cpu().numpy()
            n_stale = int(shard_counts.sum())
        else:
            n_stale = int(stale.sum())
        tp = state.temporal
        slab_cut, root_expand, rho, cam0 = tp.slab_cut0, tp.root_expand0, tp.rho, tp.cam0
        if n_stale > 0:
            empty = False
            if n_shards > 1:
                bucket = ls.pow2_bucket(int(shard_counts.max()), stale.numel())
                empty = int(shard_counts[mesh.index("clients")]) == 0
            else:
                bucket = ls.pow2_bucket(n_stale, stale.numel())
            if empty:
                sel_b = sel_s = torch.zeros((bucket,), dtype=torch.int64, device=stale.device)
            else:
                sel_b, sel_s = _compact_stale_pairs(stale, bucket)
            f_cut, f_rexp, f_rho = _pooled_pair_sweep(
                tables, rpe, cams, tau_b, sel_b, sel_s, focal, max_depth=m.slab_max_depth,
                mesh=mesh, slab_blocks=m.Ns // tables.mu.shape[0])
            slab_cut, root_expand, rho, cam0 = _apply_pooled_updates(
                slab_cut, root_expand, rho, cam0, sel_b, sel_s, f_cut, f_rexp, f_rho,
                cams[sel_b], guard=empty)
    # the scatter never touches a slot outside `eff`; freeze the other two
    # leaves the same way, so an inactive slot stays at its reset value and
    # a slot that sat out keeps its own
    temporal = ls.TemporalState(
        cam0=cam0, rho=rho,
        parent_expand0=torch.where(eff[:, None], rpe, tp.parent_expand0),
        slab_cut0=slab_cut, root_expand0=root_expand,
        swept=tp.swept | eff[:, None])
    nodes_touched = m.T + stale.sum(1).to(torch.int32) * m.S
    cut = ls.CutResult(top_cut=top_cut, slab_cut=slab_cut, root_expand=root_expand,
                       resweep=stale, nodes_touched=nodes_touched)
    return _finish_sync(tree, cfg, state, temporal, ls.batched_cut_mask(cut, tree),
                        nodes_touched, stale.sum(1), bytes_per_g, codec=codec,
                        dedup=dedup, delta_budget=delta_budget, priority=priority,
                        allowance=allowance, page_size=page_size,
                        participate=participate, mesh=mesh, n_shards=n_shards)


# ---------------------------------------------------------------------------
# fleet render step (cloud-rendered fallback clients)
# ---------------------------------------------------------------------------


def _masked_queue(gaussians: Gaussians, gids: torch.Tensor) -> Gaussians:
    """One client's render queue from its cut ids (-1 padding → α = 0 rows)."""
    queue = gaussians.slice_rows(gids.clamp_min(0))
    return dataclasses.replace(queue, opacity=torch.where(
        gids >= 0, queue.opacity, torch.zeros((), device=gids.device)))


def service_render_step(tree: LodTree, state: ServiceState, rigs,
                        rcfg: rnd.RenderConfig, *, path: str = "vmap"):
    """Render every client's current cut queue on the cloud (the fallback
    tier of Fig. 10: headsets too weak to rasterize receive pixels). Queues
    are gathered from the tree's raw attributes. `rigs` lead with the slot
    axis (`render.stack_rigs`); `path` is "vmap" (per client) or "pooled"
    (the fleet's occupied tiles in one K2 launch). Returns (img_l
    (C,H,W,3), img_r, per-client StereoFrameStats). A free slot's queue is
    empty and the pooled path gives its tiles to no launch: it renders
    black."""
    queues = pytree.stack([_masked_queue(tree.gaussians, g) for g in state.cut_gids])
    return rnd.batched_render_stereo(queues, rigs, rcfg, path=path,
                                     active=state.fleet.active)


class LodService:
    """Thin stateful wrapper: one shared tree and codec, a ragged fleet.

    `sync(cam_positions)` advances every live client by one LoD sync and
    returns per-slot `ServiceStats` (free slots' rows are zero); the
    encode-once payload of the latest sync is kept on `last_delta`
    (`client_delta(cid)` decodes one client's slice). `mode` picks the
    scheduler: "pooled" (the fleet's stale pairs in one K6 launch) or
    "vmapped" (each slot's full search; K1 per slot). `dedup` toggles the
    encode-once wire format. `taus` gives each initial client its own
    foveated LoD threshold. `render_fallback(rigs)` renders every live
    client's queue on the cloud.

    Fleet lifecycle: `admit(cam, tau)` returns a stable client id (ids are
    monotone, never reused), `evict(client_id)` frees its slot. Clients live
    in a `capacity`-slot array (default capacity == n_clients); an admit
    into a full array grows it to the next pow2 bucket, `maybe_shrink()`
    compacts a sparse fleet into the smallest bucket that holds it
    (survivors replay bitwise). `max_clients` / `max_state_bytes` turn
    growth into backpressure: an admit past the budget raises
    `AdmissionDenied` (or returns None with `required=False`) and leaves the
    service untouched. Clients are addressed by stable id everywhere.

    The Δ stream is paged: a sync whose union exceeds `delta_budget` ships
    the coarsest `page_size`-row pages and carries the rest as per-slot
    debt. `bandwidth` (a `BANDWIDTH_TIERS` name, bytes a sync, or one of
    those per client) turns on the closed-loop bitrate controller
    (`rate_control_step`): each sync, the previous sync's measured bytes set
    the client's row allowance and, at the one-page floor, its τ scale.
    `nack(cid, pages)` re-queues the rows of lost pages as debt.
    `sync(participate=...)` syncs only some clients (the deadline
    scheduler's primitive).

    The tree moves to `device` (the card when None; where there is no card
    that raises, unless the caller asks for the CPU).

    `mesh` (a `repro_torch.sharding.fleet.FleetMesh`, else the ambient
    `use_fleet_mesh` one) runs the service on the clients×slabs serving
    mesh, one process a rank, every rank calling the same methods with the
    same arguments: `state`, the stats `sync` returns, the fallback frames
    and the Δ payload's per-slot rows are this rank's client block
    (`gather_slots` brings the whole fleet), the slab tables its `slabs`
    block. The results are the meshless service's bits. `resize_mesh` moves
    the live service onto another mesh, or off it."""

    def __init__(self, tree: LodTree, cfg: SessionConfig, n_clients: int, focal: float,
                 mode: str = "pooled", taus=None, dedup: bool = True,
                 delta_budget: Optional[int] = None, capacity: Optional[int] = None,
                 max_clients: Optional[int] = None,
                 max_state_bytes: Optional[float] = None, bandwidth=None,
                 page_size: Optional[int] = None, device: DeviceLike = None,
                 mesh=None):
        if mode not in ("pooled", "vmapped"):
            raise ValueError(f"unknown scheduler mode: {mode!r}")
        if n_clients < 0:
            raise ValueError(f"n_clients must be >= 0, got {n_clients}")
        self.device = resolve_device(device)
        self.tree = tree if tree.device == self.device else tree.to(self.device)
        self.cfg = cfg
        self.mesh = shd.resolve_mesh(mesh)
        self.max_clients = None if max_clients is None else int(max_clients)
        self.max_state_bytes = None if max_state_bytes is None else float(max_state_bytes)
        self.capacity = max(int(n_clients), 1) if capacity is None else int(capacity)
        if self.capacity < max(n_clients, 1):
            raise ValueError(f"capacity {self.capacity} < n_clients {n_clients}")
        self.focal = float(np.float32(focal))
        self.mode = mode
        self.dedup = bool(dedup)
        # host mirror of state.fleet: slot lookups without reading the card
        self._active = np.zeros(self.capacity, bool)
        self._active[:n_clients] = True
        self._client_ids = np.full(self.capacity, -1, np.int64)
        self._client_ids[:n_clients] = np.arange(n_clients)
        self._next_id = int(n_clients)
        self._slot_cams = np.zeros((self.capacity, 3), np.float32)
        # per-slot foveated thresholds (admitted clients get theirs at admit)
        if taus is None:
            self.taus = None
        else:
            per_client = _fleet_taus(cfg, n_clients, taus, "cpu").numpy()
            self.taus = np.full(self.capacity, cfg.tau, np.float32)
            self.taus[:n_clients] = per_client
        self.codec, self.bytes_per_g = session_wire_format(self.tree, cfg)
        # every client's Δcut is bounded by its cut budget, so the union is
        # bounded by min(capacity · cut_budget, N); recomputed when the
        # capacity changes, unless the caller pinned it
        self._delta_budget_arg = delta_budget
        self.delta_budget = (int(delta_budget) if delta_budget is not None
                             else min(self.tree.n_pad, cfg.cut_budget * self.capacity))
        if page_size is None:
            self.page_size = max(1, min(256, self.delta_budget))
        else:
            if page_size < 1:
                raise ValueError(f"page_size must be >= 1, got {page_size}")
            if page_size > self.delta_budget:
                raise ValueError(f"page_size {page_size} > delta_budget "
                                 f"{self.delta_budget}: a page must fit the Δ-stream "
                                 "budget")
            self.page_size = int(page_size)
        self._priority = self.tree.node_levels()
        # the bitrate controller (host side): per-slot byte target (inf =
        # uncontrolled), row allowance (-1 = uncontrolled), τ scale
        self._bw_target = np.full(self.capacity, np.inf, np.float64)
        self._allowance = np.full(self.capacity, -1, np.int64)
        self._tau_scale = np.ones(self.capacity, np.float32)
        self._last_stats: Optional[ServiceStats] = None
        # rows of _last_stats the previous sync renewed: a slot that sat out
        # keeps an older row, which the controller must not take twice
        self._stats_fresh = np.zeros(self.capacity, bool)
        if bandwidth is not None:
            if isinstance(bandwidth, (list, tuple, np.ndarray)):
                if len(bandwidth) != n_clients:
                    raise ValueError(f"expected {n_clients} bandwidth entries, got "
                                     f"{len(bandwidth)}")
                targets = [_bandwidth_bytes(bw) for bw in bandwidth]
            else:
                targets = [_bandwidth_bytes(bandwidth)] * n_clients
            for slot, target in enumerate(targets):
                self._set_bandwidth_slot(slot, target)
        self.tables = (ls.SlabTables.from_tree(self.tree, mesh=self.mesh)
                       if mode == "pooled" else None)
        self.state = shd.shard_service_state(
            self.mesh, service_init(self.tree, cfg, n_clients, capacity=self.capacity))
        self.last_delta: Optional[dp.DeltaBatch] = None
        self._syncs = 0           # syncs run: the step id of their spans
        # which client each row of last_delta is for
        self._delta_ids = np.full(self.capacity, -1, np.int64)

    # -- fleet lifecycle ------------------------------------------------------

    @property
    def n_clients(self) -> int:
        """Live clients."""
        return int(self._active.sum())

    @property
    def active_ids(self):
        """Stable ids of the live clients in slot order (the order of
        `sync`'s array-form camera positions)."""
        return [int(c) for c in self._client_ids[self._active]]

    def _slot_of(self, client_id: int) -> int:
        slots = np.flatnonzero(self._active & (self._client_ids == int(client_id)))
        if slots.size == 0:
            raise KeyError(f"no live client with id {client_id}")
        return int(slots[0])

    # -- the serving mesh -------------------------------------------------------

    @property
    def client_shards(self) -> int:
        """Client shards the slot axis is split into (1: every rank holds
        every slot)."""
        return shd.client_shards(self.mesh, self.capacity)

    def slot_block(self) -> Tuple[int, int]:
        """[lo, hi) of the slots this rank holds."""
        return shd.block(self.mesh, "clients", self.client_shards, self.capacity)

    @property
    def _slab_blocks(self) -> int:
        """Blocks the slab tables are in over `slabs` (1: whole)."""
        return self.tree.meta.Ns // self.tables.mu.shape[0]

    def _local_slot(self, slot: int) -> Optional[int]:
        lo, hi = self.slot_block()
        return slot - lo if lo <= slot < hi else None

    def gather_slots(self, tree):
        """The whole fleet's rows of a tree held as this rank's client block
        (the state, `sync`'s stats, fallback frames): an all-gather over
        `clients`; the tree itself without client shards."""
        return shd.replicate_fleet(self.mesh, tree, self.client_shards)

    _DELTA_ROWS = ("ref_mask", "delivered", "deferred", "client_overflow",
                   "client_pages")

    def _unblock(self):
        """(state, last stats, the latest payload's per-slot rows) of the
        whole fleet, gathered under the current mesh and capacity."""
        ld = self.last_delta
        rows = None if ld is None else tuple(getattr(ld, f) for f in self._DELTA_ROWS)
        return self.gather_slots((self.state, self._last_stats, rows))

    def _block(self, state, stats, rows) -> None:
        """Keep this rank's block, under the current mesh and capacity, of
        the whole fleet's state, last stats and payload rows (rows padded
        to the capacity with zero rows: a payload older than a growth has
        none for the new slots, which no client reads)."""
        mesh = self.mesh
        self.state = shd.shard_service_state(mesh, state)
        self._last_stats = shd.shard_service_state(mesh, stats)
        if rows is not None:
            if mesh is not None:
                rows = tuple(torch.cat([a, a.new_zeros((self.capacity - a.shape[0],)
                                                       + tuple(a.shape[1:]))])
                             for a in rows)
            self.last_delta = dataclasses.replace(
                self.last_delta, **dict(zip(self._DELTA_ROWS,
                                            shd.shard_service_state(mesh, rows))))

    def placements(self):
        """The placement record of the service's trees under its mesh: for
        `state`, the slab `tables` and `last_delta`, a tree of specs (tuples
        of mesh axes, one entry a dimension, as the reference's
        `PartitionSpec`s), None for an absent tree. None without a mesh."""
        mesh = self.mesh
        if mesh is None:
            return None
        out = {"state": shd.fleet_shardings(
            mesh, shd.global_shapes(self.state, self.client_shards)), "tables": None,
            "last_delta": None}
        if self.tables is not None:
            out["tables"] = shd.slab_shardings(
                mesh, shd.global_shapes(self.tables, self._slab_blocks))
        ld = self.last_delta
        if ld is not None:
            rows = tuple(getattr(ld, f) for f in self._DELTA_ROWS)
            per_slot = shd.fleet_shardings(mesh, shd.global_shapes(rows, self.client_shards))
            payload = pytree.tree_map(
                lambda x: shd.fleet_pspec(mesh, ("union",) + (None,) * (x.dim() - 1),
                                          (x.shape[0] * ld.payload_shards,) + x.shape[1:]),
                ld.payload)
            whole = pytree.tree_map(lambda x: (None,) * x.dim(), ld)
            out["last_delta"] = dataclasses.replace(
                whole, payload=payload, **dict(zip(self._DELTA_ROWS, per_slot)))
        return out

    def resize_mesh(self, mesh) -> None:
        """Move the live service onto another serving mesh (bigger, smaller,
        or None for the meshless layout) without dropping a client: every
        rank gathers the whole state and the latest payload under the old
        mesh and keeps its block under the new one; the slab tables are
        views of the tree every rank holds, blocked anew. Every rank of the
        old mesh's world calls it. The results stay bitwise."""
        whole = self._unblock()
        if self.tables is not None:
            self.tables = ls.SlabTables.from_tree(self.tree, mesh=mesh)
        if self.last_delta is not None:
            self.last_delta = dataclasses.replace(
                self.last_delta, payload=dp.replicate_payload(self.mesh, self.last_delta),
                payload_shards=1)
        self.mesh = mesh
        self._block(*whole)

    def client_tau(self, client_id: int) -> float:
        """One live client's base LoD threshold (the controller's τ scale
        multiplies it during a sync)."""
        slot = self._slot_of(client_id)
        return float(self.cfg.tau if self.taus is None else self.taus[slot])

    def _set_bandwidth_slot(self, slot: int, target: float) -> None:
        """Seed one slot's controller: its byte target and a first allowance
        of target / bytes-per-row (-1 when uncontrolled)."""
        self._bw_target[slot] = target
        self._tau_scale[slot] = 1.0
        if np.isfinite(target):
            rows = int(target // max(self.bytes_per_g, 1.0))
            self._allowance[slot] = int(np.clip(rows, self.page_size, self.delta_budget))
        else:
            self._allowance[slot] = -1

    def set_bandwidth(self, client_id: int, bandwidth=None) -> None:
        """Re-tier a live client's downlink (a tier name, bytes a sync, or
        None for no control): its controller is reseeded as at admission."""
        self._set_bandwidth_slot(self._slot_of(client_id), _bandwidth_bytes(bandwidth))

    def client_bandwidth(self, client_id: int):
        """(target bytes, row allowance, τ scale) of one live client (inf and
        None when uncontrolled)."""
        slot = self._slot_of(client_id)
        allow = int(self._allowance[slot])
        return (float(self._bw_target[slot]), None if allow < 0 else allow,
                float(self._tau_scale[slot]))

    def _slot_state_bytes(self) -> float:
        """Device bytes of the service state a slot: every slot-axis leaf of
        `ServiceState` (the fleet's bookkeeping included) over the slots it
        holds; the unit of the admission byte budget (a client block's is the
        whole fleet's)."""
        total = sum(x.numel() * x.element_size() for x in pytree.leaves(self.state)
                    if x.dim() >= 1)
        return float(total) / self.state.capacity

    def _admission_denial(self) -> Optional[str]:
        """Why the next admit must be refused (None: it may go ahead),
        decided before anything changes."""
        if self.max_clients is not None and self.n_clients + 1 > self.max_clients:
            return (f"live clients {self.n_clients} at the configured "
                    f"max_clients={self.max_clients}")
        if self.max_state_bytes is not None and not (~self._active).any():
            # a full fleet must grow to admit: deny when the grown slot array
            # would pass the byte budget (an admit into a free slot is free)
            grown = flt.fleet_capacity(self.capacity + 1)
            need = self._slot_state_bytes() * grown
            if need > self.max_state_bytes:
                return (f"growing {self.capacity}->{grown} slots needs {need:.0f} state "
                        f"bytes > max_state_bytes={self.max_state_bytes:.0f}")
        return None

    def admit(self, cam=None, tau: Optional[float] = None, required: bool = True,
              bandwidth=None) -> Optional[int]:
        """Admit one client; returns its stable id. Its slot starts fresh, so
        its first sync is a cold full sweep and a cold Δcut. A full slot
        array grows to the next pow2 bucket first. `cam` seeds the slot's
        camera, `tau` its LoD threshold (default cfg.tau), `bandwidth` its
        downlink tier (default uncontrolled). Past `max_clients` or
        `max_state_bytes` the admit is denied: `AdmissionDenied`, or None
        with `required=False`, and nothing changes."""
        denial = self._admission_denial()
        if denial is not None:
            if required:
                raise AdmissionDenied(denial)
            return None
        free = np.flatnonzero(~self._active)
        if free.size == 0:
            if self.capacity >= flt.MAX_CAPACITY:
                raise ValueError(f"fleet at MAX_CAPACITY ({flt.MAX_CAPACITY})")
            self._grow(flt.fleet_capacity(self.capacity + 1))
            free = np.flatnonzero(~self._active)
        slot = int(free[0])
        client_id = self._next_id
        self._next_id += 1
        local = self._local_slot(slot)
        self.state = (service_note_admit(self.state, client_id) if local is None
                      else service_admit_slot(self.state, local, client_id))
        self._active[slot] = True
        self._client_ids[slot] = client_id
        self._slot_cams[slot] = (np.zeros(3, np.float32) if cam is None
                                 else np.asarray(cam, np.float32))
        if tau is not None and self.taus is None:
            self.taus = np.full(self.capacity, self.cfg.tau, np.float32)
        if self.taus is not None:
            self.taus[slot] = float(self.cfg.tau if tau is None else tau)
        self._set_bandwidth_slot(slot, _bandwidth_bytes(bandwidth))
        return client_id

    def evict(self, client_id: int) -> None:
        """Evict a live client: its slot is freed and reset at once. Its
        pending debt and its controller state go with it."""
        slot = self._slot_of(client_id)
        local = self._local_slot(slot)
        if local is not None:
            self.state = service_evict_slot(self.state, local)
        self._active[slot] = False
        self._client_ids[slot] = -1
        self._slot_cams[slot] = 0.0
        if self.taus is not None:
            self.taus[slot] = self.cfg.tau
        self._bw_target[slot] = np.inf
        self._allowance[slot] = -1
        self._tau_scale[slot] = 1.0
        self._stats_fresh[slot] = False

    def _grow(self, new_capacity: int) -> None:
        """Pad every slot-axis array, host mirrors included, to
        `new_capacity` (under a mesh the blocks are cut anew: growing 8 → 16
        slots on 2 client shards moves slots 4–7 to shard 0)."""
        state, stats, rows = self._unblock()
        state = service_grow(self.tree, self.cfg, state, new_capacity)
        pad = new_capacity - self.capacity
        self._active = np.concatenate([self._active, np.zeros(pad, bool)])
        self._client_ids = np.concatenate([self._client_ids, np.full(pad, -1, np.int64)])
        self._slot_cams = np.concatenate([self._slot_cams, np.zeros((pad, 3), np.float32)])
        if self.taus is not None:
            self.taus = np.concatenate([self.taus, np.full(pad, self.cfg.tau, np.float32)])
        # the new slots have no slice in the latest payload
        self._delta_ids = np.concatenate([self._delta_ids, np.full(pad, -1, np.int64)])
        self._bw_target = np.concatenate([self._bw_target, np.full(pad, np.inf)])
        self._allowance = np.concatenate([self._allowance, np.full(pad, -1, np.int64)])
        self._tau_scale = np.concatenate([self._tau_scale, np.ones(pad, np.float32)])
        self._stats_fresh = np.concatenate([self._stats_fresh, np.zeros(pad, bool)])
        if stats is not None:
            # zero rows for the new slots: uncontrolled until admitted, and a
            # zero measurement is never read for them
            stats = pytree.tree_map(
                lambda a: torch.cat([a, a.new_zeros((new_capacity - a.shape[0],)
                                                    + tuple(a.shape[1:]))]), stats)
        self.capacity = new_capacity
        if self._delta_budget_arg is None:
            self.delta_budget = min(self.tree.n_pad, self.cfg.cut_budget * self.capacity)
        self._block(state, stats, rows)

    def maybe_shrink(self) -> Optional[int]:
        """If the live clients fit a smaller pow2 bucket, move them to the
        front (slot order kept) and cut every slot-axis array to that bucket.
        Returns the new capacity, or None. Survivors replay bitwise: every
        sync computation is slot-parallel and their order is kept. The
        latest payload's per-slot rows and the controller's feedback follow
        the same permutation, so `client_delta` still reads the right
        slice."""
        target = flt.fleet_capacity(max(self.n_clients, 1))
        if target >= self.capacity:
            return None
        live = np.flatnonzero(self._active)
        free = np.flatnonzero(~self._active)
        perm = np.concatenate([live, free])[:target].astype(np.int64)
        state, stats, rows = self._unblock()
        state = service_shrink(state, perm)
        self._active = self._active[perm]
        self._client_ids = self._client_ids[perm]
        self._slot_cams = self._slot_cams[perm]
        if self.taus is not None:
            self.taus = self.taus[perm]
        self.capacity = target
        if self._delta_budget_arg is None:
            self.delta_budget = min(self.tree.n_pad, self.cfg.cut_budget * self.capacity)

        def remap_rows(a):
            # a tree from before a growth is shorter: its missing rows are 0
            idx = torch.as_tensor(np.minimum(perm, a.shape[0] - 1), device=a.device)
            keep = torch.as_tensor(perm < a.shape[0], device=a.device)
            return torch.where(keep.reshape((-1,) + (1,) * (a.dim() - 1)), a[idx],
                               torch.zeros((), dtype=a.dtype, device=a.device))

        self._block(state, pytree.tree_map(remap_rows, stats),
                    None if rows is None else tuple(map(remap_rows, rows)))
        self._delta_ids = self._delta_ids[perm]
        self._bw_target = self._bw_target[perm]
        self._allowance = self._allowance[perm]
        self._tau_scale = self._tau_scale[perm]
        self._stats_fresh = self._stats_fresh[perm]
        return target

    # -- snapshot / restore ------------------------------------------------------

    def snapshot(self, directory: str, step: int = 0, *, journal_seq: int = 0) -> str:
        """Atomically write the whole service (`ServiceState`, the host
        control-plane mirrors, the bitrate controller's state, the static
        config) as checkpoint `step_<step>` under `directory`
        (`repro_torch.serve.recovery.snapshot_service`). Returns the final
        path."""
        from repro_torch.serve import recovery
        return recovery.snapshot_service(self, directory, step=step,
                                         journal_seq=journal_seq)

    @classmethod
    def restore(cls, tree: LodTree, directory: str, step: Optional[int] = None,
                device: DeviceLike = None, mesh=None) -> "LodService":
        """Rebuild a service from a snapshot of either package against the
        same shared city tree (fingerprint-checked), its tensors on `device`
        (the card when None), onto the serving `mesh` (None: meshless;
        reshard-on-load, whatever mesh the snapshot was taken under). A
        torn, corrupt or mismatched snapshot raises
        `repro_torch.serve.recovery.RecoveryError`."""
        from repro_torch.serve import recovery
        return recovery.restore_service(tree, directory, step=step, device=device,
                                        mesh=mesh)

    # -- sync -----------------------------------------------------------------

    def _participation_mask(self, participate) -> Optional[np.ndarray]:
        """`sync`'s `participate` as a (capacity,) bool slot mask (None:
        lockstep): a bool array of the capacity's length as it is, anything
        else an iterable of client ids (an unknown id raises before anything
        changes)."""
        if participate is None:
            return None
        arr = np.asarray(participate)
        if arr.dtype == bool:
            if arr.shape != (self.capacity,):
                raise ValueError(f"participation mask shape {arr.shape} != "
                                 f"({self.capacity},)")
            return arr.copy()
        slots = [self._slot_of(int(c)) for c in np.atleast_1d(arr)]
        return flt.slots_mask(self.capacity, slots)

    def sync(self, cam_positions=None, participate=None) -> ServiceStats:
        """One fleet sync; per-slot stats on the device.

        `cam_positions` is an (n_clients, 3) array addressing the live
        clients in slot order (`active_ids`), a {client_id: position} dict
        updating some of them (an unknown id raises before any position is
        stored), or None (everyone keeps theirs). `participate` (a
        (capacity,) bool mask or client ids) makes it a partial-fleet sync:
        only those slots sync, every other slot's state survives bitwise and
        its stats row is zero.

        With bandwidth-controlled clients the previous sync's bytes are read
        back here to close the loop; after a partial sync only the slots that
        took part commit a controller update."""
        tracing.step("sync", self._syncs)
        self._syncs += 1
        with tracing.span("sync"):
            part_mask = self._participation_mask(participate)
            if isinstance(cam_positions, dict):
                updates = {self._slot_of(cid): np.asarray(pos, np.float32)
                           for cid, pos in cam_positions.items()}
                for slot, pos in updates.items():
                    self._slot_cams[slot] = pos
            elif cam_positions is not None:
                cams = np.asarray(cam_positions, np.float32)
                if cams.shape != (self.n_clients, 3):
                    raise ValueError(f"expected ({self.n_clients}, 3) camera positions, "
                                     f"got {cams.shape}")
                self._slot_cams[self._active] = cams
            allowance, taus_eff = None, self.taus
            if self.dedup and np.isfinite(self._bw_target).any():
                if self._last_stats is not None:
                    measured = self.gather_slots(
                        self._last_stats.sync_bytes).cpu().numpy().astype(np.float64)
                    new_allow, new_tau = rate_control_step(
                        self._bw_target, measured, self._allowance, self._tau_scale,
                        page_size=self.page_size, max_rows=self.delta_budget)
                    commit = self._stats_fresh
                    self._allowance = np.where(commit, new_allow, self._allowance)
                    self._tau_scale = np.where(commit, new_tau,
                                               self._tau_scale).astype(np.float32)
                allowance = np.where(self._allowance >= 0, self._allowance,
                                     self.delta_budget).astype(np.int32)
                base = (self.taus if self.taus is not None
                        else np.full(self.capacity, self.cfg.tau, np.float32))
                taus_eff = (base * self._tau_scale).astype(np.float32)
            # every per-slot argument is this rank's block of the slots
            lo, hi = self.slot_block()
            local_part = None if part_mask is None else shd.shard_participation(self.mesh,
                                                                                 part_mask)
            kw = dict(taus=None if taus_eff is None else taus_eff[lo:hi], codec=self.codec,
                      dedup=self.dedup, delta_budget=self.delta_budget, priority=self._priority,
                      allowance=None if allowance is None else allowance[lo:hi],
                      page_size=self.page_size, participate=local_part, mesh=self.mesh,
                      n_shards=self.client_shards)
            cams = self._slot_cams[lo:hi]
            if self.mode == "pooled":
                self.state, stats, batch = service_sync_pooled(
                    self.tree, self.cfg, self.state, cams, self.focal, self.bytes_per_g,
                    tables=self.tables, **kw)
            else:
                self.state, stats, batch = service_sync_vmapped(
                    self.tree, self.cfg, self.state, cams, self.focal, self.bytes_per_g, **kw)
            if batch is not None:
                self.last_delta = batch
                self._delta_ids = self._client_ids.copy()
            # the controller's next measurement: after a partial sync each slot
            # keeps its latest observed row
            if part_mask is None or self._last_stats is None:
                self._last_stats = stats
            else:
                pm = torch.as_tensor(local_part, device=self.device)
                self._last_stats = pytree.tree_map(
                    lambda n, o: torch.where(pm.reshape((-1,) + (1,) * (n.dim() - 1)), n, o),
                    stats, self._last_stats)
            self._stats_fresh = (self._active.copy() if part_mask is None
                                 else self._active & part_mask)
        return stats

    def client_cut(self, client_id: int) -> torch.Tensor:
        """(cut_budget,) int32 render-queue ids of one live client (-1
        padded); under a mesh, from its client shard to every rank."""
        return shd.gather_row(self.mesh, self.state.cut_gids, self._slot_of(client_id),
                              self.client_shards)

    def _payload_slot(self, client_id: int, what: str) -> int:
        """The slot of a client that has a slice in the latest payload."""
        if self.last_delta is None:
            raise ValueError("no sync performed yet (or dedup=False)")
        slot = self._slot_of(client_id)
        if slot >= len(self._delta_ids) or self._delta_ids[slot] != client_id:
            raise ValueError(f"latest payload predates client {client_id}'s admission "
                             f"— {what}")
        return slot

    def _client_payload(self, client_id: int, what: str) -> dp.DeltaBatch:
        """The latest payload with one client's ref row alone (row 0), the
        row and the union's rows gathered from their shards."""
        slot = self._payload_slot(client_id, what)
        ld = self.last_delta
        row = shd.gather_row(self.mesh, ld.ref_mask, slot, self.client_shards)
        return dataclasses.replace(ld, ref_mask=row[None],
                                   payload=dp.replicate_payload(self.mesh, ld),
                                   payload_shards=1)

    def client_delta(self, client_id: int):
        """One client's slice of the latest encode-once payload, decoded:
        (ids (U,) int32, -1 where the union row is not its; decoded rows).
        A client admitted (or a slot recycled) after that sync has no slice:
        that raises."""
        return dp.decode_client(self.codec, self._client_payload(client_id, "sync first"),
                                self.tree.gaussians.sh.shape[1], 0)

    def delta_checksums(self) -> np.ndarray:
        """(pages,) uint32 checksums of the latest sync's pages (the page
        headers' values)."""
        if self.last_delta is None:
            raise ValueError("no sync performed yet (or dedup=False)")
        return dp.page_checksums(self.last_delta)

    def resolve_nack(self, client_id: int, lost_pages) -> np.ndarray:
        """The ascending gids client `client_id` ingested from the named pages
        of the latest sync's stream: what those pages' loss costs it. Reads
        nothing but the payload; `nack` applies it."""
        batch = self._client_payload(client_id, "nothing to NACK")
        n_pages = int(batch.pages)
        pages = sorted(set(int(p) for p in lost_pages))
        bad = [p for p in pages if not 0 <= p < n_pages]
        if bad:
            raise ValueError(f"NACK names pages {bad} outside the latest stream's "
                             f"{n_pages} pages")
        return np.flatnonzero(dp.lost_row_mask(batch, 0, pages))

    def nack_rows(self, client_id: int, gids) -> int:
        """Re-queue the given Gaussians as one live client's pending debt:
        they return through the next sync's priority stream. Returns the
        rows queued."""
        slot = self._slot_of(client_id)
        g = np.asarray(list(gids), np.int64)
        if g.size and (g.min() < 0 or g.max() >= self.tree.n_pad):
            raise ValueError(f"NACK gids outside [0, {self.tree.n_pad})")
        mask = np.zeros((self.tree.n_pad,), bool)
        mask[g] = True
        local = self._local_slot(slot)
        if local is not None:
            self.state = service_nack_rows(self.state, local, mask)
        return int(mask.sum())

    def nack(self, client_id: int, lost_pages) -> int:
        """A client reports lost pages of the latest sync's stream: the rows
        it took from them become its pending debt (`resolve_nack` +
        `nack_rows`). Returns the rows re-queued."""
        return self.nack_rows(client_id, self.resolve_nack(client_id, lost_pages))

    # -- fallback rendering ---------------------------------------------------

    def _slot_aligned_rigs(self, rigs):
        """An n_clients rig list (slot order) as a capacity-length list; a
        free slot borrows the first rig only for its shape: its queue is
        empty and the pooled path gives its tiles no launch."""
        rigs = list(rigs)
        if self.n_clients == 0:
            raise ValueError("no live clients to render (fleet is empty)")
        if len(rigs) == self.capacity and self.n_clients == self.capacity:
            return rigs
        if len(rigs) != self.n_clients:
            raise ValueError(f"expected {self.n_clients} rigs (one per live client, "
                             f"slot order), got {len(rigs)}")
        slot_rigs = [rigs[0]] * self.capacity
        for slot, rig in zip(np.flatnonzero(self._active), rigs):
            slot_rigs[int(slot)] = rig
        return slot_rigs

    def render_fallback(self, rigs, *, tile: int = 16, list_len: int = 256,
                        max_pairs: int = 1 << 16, path: str = "vmap"):
        """Fleet render of every live client's queue → (img_l, img_r, stats)
        with a leading slot axis (free slots render black). `rigs` is a list
        of n_clients StereoRigs (one resolution and baseline; slot order).
        Under a mesh each client shard renders its own slots (its `slabs`
        ranks repeat the work) and returns their frames."""
        rigs = self._slot_aligned_rigs(rigs)
        rcfg = rnd.RenderConfig.for_fleet(rigs, tile=tile, list_len=list_len,
                                          max_pairs=max_pairs)
        lo, hi = self.slot_block()
        return service_render_step(self.tree, self.state, rnd.stack_rigs(rigs[lo:hi]),
                                   rcfg, path=path)
