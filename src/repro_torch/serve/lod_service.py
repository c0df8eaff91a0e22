"""Batched multi-client LoD service — the cloud half of paper Fig. 9/10 for B
headsets on one shared city tree. Port of `repro.serve.lod_service`: the
functional core and a fixed-fleet `LodService`.

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

Both schedulers give the same bits. Runtime admission and eviction,
capacity growth and shrink, rate control, NACK retransmit, partial-fleet
syncs and the serving mesh are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch import render as rnd
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


@dataclasses.dataclass(frozen=True)
class ServiceState:
    """All per-client cloud state, on a leading (C, ...) slot axis.

    pending: (C, N) bool — Δ rows owed to the slot from earlier paged syncs
    (deferred by the stream budget), folded into the next sync's union until
    they ship. `fleet` records which slots hold a live client."""

    mgr: mgr.ManagerState       # leaves (C, N)
    temporal: ls.TemporalState  # leaves (C, Ns, ...)
    cut_gids: torch.Tensor      # (C, cut_budget) int32, -1 padded
    sync_index: torch.Tensor    # (C,) int32 — per-slot syncs while active
    pending: torch.Tensor       # (C, N) bool
    fleet: flt.FleetState


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
    mtp_ms: torch.Tensor            # float32 — stamped by a deadline
    #                                 scheduler; 0 on the sync paths
    deadline_miss: torch.Tensor     # bool — likewise; False on the sync paths


def service_init(tree: LodTree, cfg: SessionConfig, n_clients: int) -> ServiceState:
    """Service state for `n_clients` live clients, one slot each, on the
    tree's device."""
    m, dev = tree.meta, tree.device
    cap = max(n_clients, 1)
    return ServiceState(
        mgr=pytree.tree_map(lambda a: a.expand((cap,) + a.shape).clone(),
                            mgr.ManagerState.initial(tree.n_pad, dev)),
        temporal=ls.TemporalState.initial_batched(m.Ns, m.S, cap, dev),
        cut_gids=torch.full((cap, cfg.cut_budget), -1, dtype=torch.int32, device=dev),
        sync_index=torch.zeros((cap,), dtype=torch.int32, device=dev),
        pending=torch.zeros((cap, tree.n_pad), dtype=torch.bool, device=dev),
        fleet=flt.fleet_init(cap, n_clients, device=dev),
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
                 priority=None, page_size: Optional[int] = None
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
    coarse-first rank key (default: the tree's node levels).

    Inactive slots are masked out of everything here: no cut, no table
    update, no Δ rows, 0 bytes, and their sync counter does not tick."""
    eff = state.fleet.active
    dev = masks.device
    masks = masks & eff[:, None]
    new_mgr, plan = mgr.batched_cloud_sync(state.mgr, masks, state.sync_index, cfg.w_star)
    new_mgr = flt.freeze_inactive(new_mgr, state.mgr, eff)
    gids, counts = _batched_cut_gids(masks, cfg.cut_budget)
    unicast = mgr.batched_wire_bytes(plan, bytes_per_g, active=eff)
    batch = None
    zeros_i = torch.zeros(counts.shape, dtype=torch.int32, device=dev)
    if dedup:
        if codec is None or delta_budget is None:
            raise ValueError("dedup sync needs a codec and a delta_budget")
        if priority is None:
            priority = tree.node_levels()
        batch = dp.build_delta_batch(tree.gaussians, codec, plan.delta_data, delta_budget,
                                     active=eff, pending=state.pending, priority=priority,
                                     page_size=page_size)
        sync_bytes = mgr.batched_wire_bytes(plan, bytes_per_g, shared_payload=True,
                                            active=eff, delivered=batch.delivered,
                                            client_pages=batch.client_pages)
        saved = unicast - sync_bytes
        delta_overflow = batch.client_overflow
        delta_shipped = batch.delivered.sum(1).to(torch.int32)
        # deferred rows stay owed until they ship, unless the shared reuse
        # rule evicted them meanwhile
        pending = batch.deferred & ~plan.evicted & eff[:, None]
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
        unique_delta=dp.first_owner_counts(plan.delta_data),
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
                         page_size: Optional[int] = None
                         ) -> Tuple[ServiceState, ServiceStats, Optional[dp.DeltaBatch]]:
    """One LoD sync for every client, each client's full temporal search in
    turn (K1 per client on the card): the exactness reference of the pooled
    scheduler. Inactive slots' temporal state is frozen at its reset value
    afterwards, so the state equals the pooled scheduler's bit for bit."""
    cams = torch.as_tensor(cam_positions, dtype=torch.float32, device=tree.device)
    tau_b = _fleet_taus(cfg, cams.shape[0], taus, tree.device)
    eff = state.fleet.active
    cut, temporal = ls.batched_temporal_search(tree, state.temporal, cams, focal, tau_b)
    temporal = flt.freeze_inactive(temporal, state.temporal, eff)
    masks = ls.batched_cut_mask(cut, tree)
    return _finish_sync(tree, cfg, state, temporal, masks, cut.nodes_touched,
                        cut.resweep.sum(1), bytes_per_g, codec=codec, dedup=dedup,
                        delta_budget=delta_budget, priority=priority,
                        page_size=page_size)


def _apply_pooled_updates(slab_cut, root_expand, rho, cam0, sel_b, sel_s, f_cut,
                          f_rexp, f_rho, cam_sel):
    """Scatter pooled sweep results into (copies of) the batched temporal
    state. Repeat-padded pairs write identical values."""
    at = (sel_b, sel_s)
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
                       focal: float, *, max_depth: int):
    """Gather the pooled pairs' slab attributes from the resident tables and
    sweep them in one K6 launch (its plain version on CPU tensors)."""
    return lod_pair_sweep(tables.mu[sel_s], tables.size[sel_s], tables.parent[sel_s],
                          tables.level[sel_s], tables.is_leaf[sel_s],
                          tables.valid[sel_s], rpe[sel_b, sel_s], cams[sel_b],
                          focal, taus[sel_b], max_depth=max_depth)


def service_sync_pooled(tree: LodTree, cfg: SessionConfig, state: ServiceState,
                        cam_positions, focal: float, bytes_per_g: float, taus=None,
                        codec: Optional[comp.Codec] = None, dedup: bool = False,
                        delta_budget: Optional[int] = None, priority=None,
                        page_size: Optional[int] = None,
                        tables: Optional[ls.SlabTables] = None
                        ) -> Tuple[ServiceState, ServiceStats, Optional[dp.DeltaBatch]]:
    """One LoD sync for every client with cross-client slab pooling.

    The top sweep and staleness test run per client; the stale (client,
    slab) pairs of the fleet are compacted on the device into one pow2
    bucket and swept in one K6 launch, each pair with its own camera and τ,
    then scattered back. The same bits as `service_sync_vmapped`. The host
    reads the pool size (and, with dedup, the Δ-union size) and nothing
    else. Inactive slots report no staleness, so they never enter the pool.
    `tables` are the resident slab tables (`SlabTables.from_tree`)."""
    m = tree.meta
    cams = torch.as_tensor(cam_positions, dtype=torch.float32, device=tree.device)
    tau_b = _fleet_taus(cfg, cams.shape[0], taus, tree.device)
    eff = state.fleet.active
    if tables is None:
        tables = ls.SlabTables.from_tree(tree)
    top_cut, rpe, stale = ls.batched_top_and_staleness(tree, state.temporal, cams,
                                                       focal, tau_b, eff)
    n_stale = int(stale.sum())
    tp = state.temporal
    slab_cut, root_expand, rho, cam0 = tp.slab_cut0, tp.root_expand0, tp.rho, tp.cam0
    if n_stale > 0:
        bucket = ls.pow2_bucket(n_stale, stale.numel())
        sel_b, sel_s = _compact_stale_pairs(stale, bucket)
        f_cut, f_rexp, f_rho = _pooled_pair_sweep(tables, rpe, cams, tau_b, sel_b, sel_s,
                                                  focal, max_depth=m.slab_max_depth)
        slab_cut, root_expand, rho, cam0 = _apply_pooled_updates(
            slab_cut, root_expand, rho, cam0, sel_b, sel_s, f_cut, f_rexp, f_rho,
            cams[sel_b])
    # the scatter never touches an inactive slot; freeze the other two
    # leaves the same way, so an inactive slot stays at its reset value
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
                        page_size=page_size)


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
    (C,H,W,3), img_r, per-client StereoFrameStats)."""
    queues = pytree.stack([_masked_queue(tree.gaussians, g) for g in state.cut_gids])
    return rnd.batched_render_stereo(queues, rigs, rcfg, path=path,
                                     active=state.fleet.active)


class LodService:
    """Thin stateful wrapper: one shared tree and codec, a fixed fleet of
    `n_clients` clients (client id == slot).

    `sync(cam_positions)` advances every client by one LoD sync and returns
    per-client `ServiceStats`; the encode-once payload of the latest sync is
    kept on `last_delta` (`client_delta(cid)` decodes one client's slice).
    `mode` picks the scheduler: "pooled" (the fleet's stale pairs in one K6
    launch) or "vmapped" (each client's full search; K1 per client). `dedup`
    toggles the encode-once wire format. `taus` gives every client its own
    foveated LoD threshold. The Δ stream is paged: a sync whose union
    exceeds `delta_budget` ships the coarsest `page_size`-row pages and
    carries the rest as per-client debt. `render_fallback(rigs)` renders
    every client's queue on the cloud.

    The tree moves to `device` (the card when None; where there is no card
    that raises, unless the caller asks for the CPU)."""

    def __init__(self, tree: LodTree, cfg: SessionConfig, n_clients: int, focal: float,
                 mode: str = "pooled", taus=None, dedup: bool = True,
                 delta_budget: Optional[int] = None, page_size: Optional[int] = None,
                 device: DeviceLike = None):
        if mode not in ("pooled", "vmapped"):
            raise ValueError(f"unknown scheduler mode: {mode!r}")
        if n_clients < 1:
            raise ValueError(f"need at least one client, got {n_clients}")
        self.device = resolve_device(device)
        self.tree = tree if tree.device == self.device else tree.to(self.device)
        self.cfg = cfg
        self.n_clients = int(n_clients)
        self.focal = float(np.float32(focal))
        self.mode = mode
        self.dedup = bool(dedup)
        self.taus = (None if taus is None
                     else _fleet_taus(cfg, self.n_clients, taus, self.device))
        self.codec, self.bytes_per_g = session_wire_format(self.tree, cfg)
        # every client's Δcut is bounded by its cut budget, so the union is
        # bounded by min(n_clients · cut_budget, N)
        self.delta_budget = (int(delta_budget) if delta_budget is not None
                             else min(self.tree.n_pad, cfg.cut_budget * self.n_clients))
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
        self._cams = np.zeros((self.n_clients, 3), np.float32)
        self.tables = ls.SlabTables.from_tree(self.tree) if mode == "pooled" else None
        self.state = service_init(self.tree, cfg, self.n_clients)
        self.last_delta: Optional[dp.DeltaBatch] = None

    def _slot_of(self, client_id: int) -> int:
        if not 0 <= int(client_id) < self.n_clients:
            raise KeyError(f"unknown client id {client_id}")
        return int(client_id)

    def sync(self, cam_positions=None) -> ServiceStats:
        """One fleet sync. `cam_positions` is an (n_clients, 3) array in
        client order, a {client_id: position} dict updating some clients
        (the others keep their last position; an unknown id raises before
        any position is stored), or None (everyone keeps theirs)."""
        if isinstance(cam_positions, dict):
            updates = {self._slot_of(cid): np.asarray(pos, np.float32)
                       for cid, pos in cam_positions.items()}
            for slot, pos in updates.items():
                self._cams[slot] = pos
        elif cam_positions is not None:
            cams = np.asarray(cam_positions, np.float32)
            if cams.shape != (self.n_clients, 3):
                raise ValueError(f"expected ({self.n_clients}, 3) camera positions, "
                                 f"got {cams.shape}")
            self._cams[:] = cams
        kw = dict(taus=self.taus, codec=self.codec, dedup=self.dedup,
                  delta_budget=self.delta_budget, priority=self._priority,
                  page_size=self.page_size)
        if self.mode == "pooled":
            self.state, stats, batch = service_sync_pooled(
                self.tree, self.cfg, self.state, self._cams, self.focal,
                self.bytes_per_g, tables=self.tables, **kw)
        else:
            self.state, stats, batch = service_sync_vmapped(
                self.tree, self.cfg, self.state, self._cams, self.focal,
                self.bytes_per_g, **kw)
        if batch is not None:
            self.last_delta = batch
        return stats

    def client_cut(self, client_id: int) -> torch.Tensor:
        """(cut_budget,) int32 render-queue ids of one client (-1 padded)."""
        return self.state.cut_gids[self._slot_of(client_id)]

    def client_delta(self, client_id: int):
        """One client's slice of the latest encode-once payload, decoded:
        (ids (U,) int32, -1 where the union row is not its; decoded rows)."""
        if self.last_delta is None:
            raise ValueError("no sync performed yet (or dedup=False)")
        return dp.decode_client(self.codec, self.last_delta,
                                self.tree.gaussians.sh.shape[1], self._slot_of(client_id))

    def render_fallback(self, rigs, *, tile: int = 16, list_len: int = 256,
                        max_pairs: int = 1 << 16, path: str = "vmap"):
        """Fleet render of every client's queue → (img_l, img_r, stats) with a
        leading client axis. `rigs` is a list of n_clients StereoRigs (one
        resolution and baseline; client order)."""
        rigs = list(rigs)
        if len(rigs) != self.n_clients:
            raise ValueError(f"expected {self.n_clients} rigs (one per client), "
                             f"got {len(rigs)}")
        rcfg = rnd.RenderConfig.for_fleet(rigs, tile=tile, list_len=list_len,
                                          max_pairs=max_pairs)
        return service_render_step(self.tree, self.state, rnd.stack_rigs(rigs), rcfg,
                                   path=path)
