"""End-to-end collaborative rendering session (paper Fig. 9 / Fig. 10).

Port of `repro.core.pipeline`.

Cloud side (per LoD sync, every `w` frames):
  temporal-aware LoD search (K1) → cut → management-table sync → Δcut
  payload → client mirror and store update.
Client side (every frame):
  render queue = received cut → shared stereo preprocessing (K3) → left
  binning → triangulation shift-merge (K4) → raster of both eyes (K2).

The core is functional: `SessionState` goes in, a new one comes out
(`cloud_sync_step` / `idle_step` / `session_step` / `client_render_step`);
`CollaborativeSession` is a thin stateful wrapper. The Δcut travels
compressed by default (`SessionConfig(use_compression=True)`: the codec's
encode, with its codeword assignment on K5, then decode on the client) or
as raw rows (`use_compression=False`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import render as rnd
from repro_torch import tracing
from repro_torch.core import compression as comp
from repro_torch.core import lod_search as ls
from repro_torch.core import manager as mgr
from repro_torch.core.camera import StereoRig
from repro_torch.core.gaussians import Gaussians
from repro_torch.core.lod_tree import LodTree
from repro_torch.core.stereo import alpha_skip_stats
from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    tau: float = 48.0            # LoD threshold τ* in pixels
    w: int = 4                   # LoD sync interval in frames (paper default)
    w_star: int = 32             # reuse window w_r* in syncs (paper default)
    cut_budget: int = 4096
    tile: int = 16
    list_len: int = 256
    max_pairs: int = 1 << 16
    k_codes: int = 256
    use_compression: bool = True


@dataclasses.dataclass
class FrameStats:
    frame: int
    synced: bool
    cut_size: int
    delta_size: int
    sync_bytes: float
    nodes_touched: int
    resweeps: int
    client_resident: int
    stereo: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class SessionState:
    """Complete per-client session state.

    mgr_state:    cloud-side management table
    client:       client-side mirror (rebuilt from wire data only)
    temporal:     per-subtree LoD-search reuse state
    client_store: client-side attribute store
    cut_gids:     (cut_budget,) int32 current render queue, -1 padded
    sync_index:   LoD syncs performed so far
    frame_index:  frames stepped so far
    """

    mgr_state: mgr.ManagerState
    client: mgr.ClientState
    temporal: ls.TemporalState
    client_store: Gaussians
    cut_gids: torch.Tensor
    sync_index: int
    frame_index: int


@dataclasses.dataclass(frozen=True)
class StepStats:
    """One frame's accounting, as 0-d tensors on the session's device."""

    synced: torch.Tensor          # () bool
    cut_size: torch.Tensor        # () int32
    delta_size: torch.Tensor      # () int32
    sync_bytes: torch.Tensor      # () float32
    nodes_touched: torch.Tensor   # () int32
    resweeps: torch.Tensor        # () int32
    client_resident: torch.Tensor  # () int32


def _empty_store(like: Gaussians) -> Gaussians:
    quat = torch.zeros_like(like.quat)
    quat[:, 0] = 1.0
    return Gaussians(mu=torch.zeros_like(like.mu), log_scale=torch.zeros_like(like.log_scale),
                     quat=quat, opacity=torch.zeros_like(like.opacity),
                     sh=torch.zeros_like(like.sh))


def session_init(tree: LodTree, cfg: SessionConfig) -> SessionState:
    """Fresh session state on the tree's device. The initial TemporalState
    is unswept everywhere, so the first sync is a full sweep."""
    m, dev = tree.meta, tree.device
    n = tree.n_pad
    return SessionState(
        mgr_state=mgr.ManagerState.initial(n, dev),
        client=mgr.ClientState.initial(n, dev),
        temporal=ls.TemporalState.initial(m.Ns, m.S, dev),
        client_store=_empty_store(tree.gaussians),
        cut_gids=torch.full((cfg.cut_budget,), -1, dtype=torch.int32, device=dev),
        sync_index=0,
        frame_index=0,
    )


def session_wire_format(tree: LodTree, cfg: SessionConfig
                        ) -> Tuple[comp.Codec, float]:
    """(codec, bytes-per-Gaussian) shared by cloud and client."""
    codec = comp.fit_codec(tree.gaussians, k_codes=cfg.k_codes, iters=6)
    bytes_per_g = (comp.wire_bytes_per_gaussian(codec)
                   if cfg.use_compression
                   else 4 * (3 + 3 + 4 + 1 + 3 * tree.gaussians.sh.shape[1]))
    return codec, float(bytes_per_g)


def cloud_sync_step(tree: LodTree, codec: comp.Codec, cfg: SessionConfig,
                    state: SessionState, cam_pos, focal: float,
                    bytes_per_g: float) -> Tuple[SessionState, StepStats]:
    """One LoD sync: temporal-aware search → management sync → Δcut payload →
    client mirror + store update."""
    with tracing.span("cloud_sync"):
        with tracing.span("lod_search"):
            cut, temporal = ls.temporal_search(tree, state.temporal, cam_pos, focal, cfg.tau)
        t = state.sync_index
        with tracing.span("manager"):
            mask = cut.mask(tree)
            mgr_state, plan = mgr.cloud_sync(state.mgr_state, mask, t, cfg.w_star)
            # single-client unicast wire format (one stream, implicit Δ ids); the
            # fleet service dedups it per sync through the same encode_rows
            ids, n_delta = mgr.gather_payload(tree.gaussians, plan.delta_data, cfg.cut_budget)
        with tracing.span("encode"):
            if cfg.use_compression:
                enc = comp.encode_rows(codec, tree.gaussians, ids)
                dec = comp.decode(codec, enc, tree.gaussians.sh.shape[1])
            else:
                dec = tree.gaussians.slice_rows(ids.clamp_min(0))
        with tracing.span("client_update"):
            client = mgr.client_sync(state.client, plan.delta_data, plan.cut_add,
                                     plan.cut_remove, t, cfg.w_star)
            client_store = _apply_payload(state.client_store, ids, dec)
            gids, count, _overflow = ls.cut_gids(cut, tree, cfg.cut_budget)
        new_state = SessionState(
            mgr_state=mgr_state, client=client, temporal=temporal,
            client_store=client_store, cut_gids=gids,
            sync_index=t + 1, frame_index=state.frame_index + 1)
        dev = tree.device
        stats = StepStats(
            synced=torch.tensor(True, device=dev),
            cut_size=count,
            delta_size=n_delta,
            sync_bytes=plan.wire_bytes(bytes_per_g),
            nodes_touched=cut.nodes_touched,
            resweeps=cut.resweep.sum().to(torch.int32),
            client_resident=plan.n_resident)
        return new_state, stats


def idle_step(state: SessionState) -> Tuple[SessionState, StepStats]:
    """A non-sync frame: the client renders its cached cut; the only uplink
    traffic is the pose."""
    dev = state.cut_gids.device
    new_state = dataclasses.replace(state, frame_index=state.frame_index + 1)
    stats = StepStats(
        synced=torch.tensor(False, device=dev),
        cut_size=(state.cut_gids >= 0).sum().to(torch.int32),
        delta_size=torch.tensor(0, dtype=torch.int32, device=dev),
        sync_bytes=torch.tensor(float(mgr.POSE_UPLINK_BYTES), dtype=torch.float32,
                                device=dev),
        nodes_touched=torch.tensor(0, dtype=torch.int32, device=dev),
        resweeps=torch.tensor(0, dtype=torch.int32, device=dev),
        client_resident=state.client.has.sum().to(torch.int32))
    return new_state, stats


def session_step(tree: LodTree, codec: comp.Codec, cfg: SessionConfig,
                 state: SessionState, cam_pos, focal: float, bytes_per_g: float
                 ) -> Tuple[SessionState, StepStats]:
    """Advance one VR frame (a sync every cfg.w frames)."""
    if state.frame_index % cfg.w == 0:
        return cloud_sync_step(tree, codec, cfg, state, cam_pos, focal, bytes_per_g)
    return idle_step(state)


def _fresh_session_like(state: SessionState) -> SessionState:
    """A freshly initialized SessionState with `state`'s shapes and device."""
    n = state.mgr_state.client_has.shape[0]
    ns, s = state.temporal.slab_cut0.shape
    dev = state.cut_gids.device
    return SessionState(
        mgr_state=mgr.ManagerState.initial(n, dev),
        client=mgr.ClientState.initial(n, dev),
        temporal=ls.TemporalState.initial(ns, s, dev),
        client_store=_empty_store(state.client_store),
        cut_gids=torch.full_like(state.cut_gids, -1),
        sync_index=0,
        frame_index=0,
    )


def admit_step(state: SessionState) -> SessionState:
    """Client admission: the freshly admitted session occupying this state's
    slot (its first sync is a cold full sweep and a cold Δcut)."""
    return _fresh_session_like(state)


def evict_step(state: SessionState) -> SessionState:
    """Client eviction: the same fresh state as admission."""
    return _fresh_session_like(state)


def _render_queue(store: Gaussians, gids: torch.Tensor) -> Gaussians:
    queue = store.slice_rows(gids.clamp_min(0))
    return dataclasses.replace(queue, opacity=torch.where(
        gids >= 0, queue.opacity, torch.zeros((), device=gids.device)))


def client_render_step(cfg: SessionConfig, state: SessionState, rig: StereoRig):
    """Render the client's current queue from its store."""
    with tracing.span("client_render"):
        return render_stereo(_render_queue(state.client_store, state.cut_gids), rig,
                             tile=cfg.tile, list_len=cfg.list_len, max_pairs=cfg.max_pairs)


def _apply_payload(store: Gaussians, ids: torch.Tensor, dec: Gaussians) -> Gaussians:
    """Scatter the Δcut rows into a copy of the client store (-1 ids are
    padding and write nothing)."""
    valid = ids >= 0
    rows = ids[valid].long()

    def put(a, b):
        return a.index_put((rows,), b[valid])

    return Gaussians(mu=put(store.mu, dec.mu), log_scale=put(store.log_scale, dec.log_scale),
                     quat=put(store.quat, dec.quat), opacity=put(store.opacity, dec.opacity),
                     sh=put(store.sh, dec.sh))


class CollaborativeSession:
    """Thin stateful wrapper over the functional core (single client).

    The tree moves to `device` (the card when None; it raises where there is
    no card and the caller did not ask for the CPU)."""

    def __init__(self, tree: LodTree, cfg: SessionConfig, rig_template: StereoRig,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.tree = tree if tree.device == self.device else tree.to(self.device)
        self.cfg = cfg
        self.codec, self.bytes_per_g = session_wire_format(self.tree, cfg)
        self.rig_template = rig_template
        self.state = session_init(self.tree, cfg)

    @property
    def mgr_state(self) -> mgr.ManagerState:
        return self.state.mgr_state

    @property
    def client(self) -> mgr.ClientState:
        return self.state.client

    @property
    def temporal(self) -> ls.TemporalState:
        return self.state.temporal

    @property
    def client_store(self) -> Gaussians:
        return self.state.client_store

    @property
    def sync_index(self) -> int:
        return self.state.sync_index

    @property
    def frame_index(self) -> int:
        return self.state.frame_index

    @property
    def current_cut_ids(self) -> Optional[torch.Tensor]:
        """The render queue's ids (cut_budget,) int32, -1 padded; None before
        the first sync."""
        return self.state.cut_gids if self.sync_index > 0 else None

    def render(self, rig: StereoRig, gids: torch.Tensor):
        """Render the client store's rows `gids` (-1 ids get opacity 0) for
        `rig`: `render_stereo` on that queue."""
        cfg = self.cfg
        return render_stereo(_render_queue(self.state.client_store, gids.to(self.device)),
                             rig, tile=cfg.tile, list_len=cfg.list_len,
                             max_pairs=cfg.max_pairs)

    def step(self, rig: StereoRig, render: bool = True):
        """Advance one VR frame. LoD sync happens every cfg.w frames."""
        frame = self.state.frame_index
        tracing.step("frame", frame)
        with tracing.span("frame"):
            focal = float(np.float32(float(self.rig_template.left.focal)))
            self.state, st = session_step(
                self.tree, self.codec, self.cfg, self.state,
                rig.left.pos.to(self.device), focal, self.bytes_per_g)
            with tracing.span("frame_stats"):
                stats = FrameStats(
                    frame=frame, synced=bool(st.synced),
                    cut_size=int(st.cut_size), delta_size=int(st.delta_size),
                    sync_bytes=float(st.sync_bytes),
                    nodes_touched=int(st.nodes_touched), resweeps=int(st.resweeps),
                    client_resident=int(st.client_resident))
            out = client_render_step(self.cfg, self.state, rig) if render else None
        return stats, out


def render_stereo(queue: Gaussians, rig: StereoRig, *, tile: int = 16,
                  list_len: int = 256, max_pairs: int = 1 << 16):
    """Client stereo pipeline: shared preprocessing → left binning →
    shift-merge → raster of both eyes. Returns (left, right, (splats,
    left lists, right lists, StereoStats))."""
    cfg = rnd.RenderConfig.for_rig(rig, tile=tile, list_len=list_len,
                                   max_pairs=max_pairs)
    plan = rnd.build_plan(queue, rig, cfg)
    img_l, img_r, hits = rnd.render_stereo(plan, cfg)
    with tracing.span("stereo_stats"):
        stats = alpha_skip_stats(plan.left, plan.right, hits, plan.splats)
    return img_l, img_r, (plan.splats, plan.left, plan.right, stats)


def render_stereo_reference(queue: Gaussians, rig: StereoRig):
    """Two fully independent untiled eye renders (the BASE baseline)."""
    return rnd.render_stereo_reference(queue, rig)
