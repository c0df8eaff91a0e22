"""Fully-streaming + temporal-aware LoD search (paper §4.2).

Port of `repro.core.lod_search`. Semantics:
  proj(n)    = size(n) * focal / dist(cam, n)
  expand(n)  = expand(parent(n)) AND proj(n) > τ        (root parent ≡ True)
  in_cut(n)  = expand(parent(n)) AND (proj(n) ≤ τ OR leaf(n))

One search = a level-major sweep of the small top-tree (plain tensor ops)
plus a sweep of every subtree slab, which runs kernel K1
(`repro_torch.kernels.lod_cut`) on the card.

Temporal reuse: after sweeping slab s at camera c0, ρ_s = min over its nodes
of |dist(c0, n) − size(n)·focal/τ|. While the camera stays within ρ_s of c0
and the slab root's parent-expand bit is unchanged, no comparison inside the
slab can flip, so the cached cut slab is exact. `temporal_search` sweeps all
slabs and selects the stale ones (the reference's jittable form);
`temporal_search_hybrid` sweeps only the stale ones.

Fleets (B clients on one tree) carry every state leaf with a leading client
axis: `batched_temporal_search` runs each client's search (K1 per client),
and the pooled service sweeps the stale (client, slab) pairs of the whole
fleet through `sweep_slab_camera_pairs`' kernel, K6.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.core.lod_tree import LodTree
from repro_torch.kernels.lod_cut import (lod_slab_sweep, pair_sweep_plain, slab_dist,
                                         slab_sweep_plain)
from repro_torch.sharding.fleet import shard_slab_tables

_EPS_DIST = 1e-6


@dataclasses.dataclass(frozen=True)
class CutResult:
    """One frame's LoD cut.

    top_cut:  (T,)    bool — cut nodes inside the top-tree
    slab_cut: (Ns, S) bool — cut nodes inside each subtree slab
    root_expand: (Ns,) bool — expand flag of each slab root
    resweep:  (Ns,)   bool — which slabs were stale this frame
    nodes_touched: () int32 — streaming work metric (top + stale slabs)
    """

    top_cut: torch.Tensor
    slab_cut: torch.Tensor
    root_expand: torch.Tensor
    resweep: torch.Tensor
    nodes_touched: torch.Tensor

    def mask(self, tree: LodTree) -> torch.Tensor:
        """(N_pad,) global cut mask."""
        return torch.cat([self.top_cut, self.slab_cut.reshape(-1)])

    def count(self) -> torch.Tensor:
        return self.top_cut.sum() + self.slab_cut.sum()


@dataclasses.dataclass(frozen=True)
class TemporalState:
    """Per-subtree reuse state for temporal-aware search."""

    cam0: torch.Tensor            # (Ns, 3) camera at last sweep
    rho: torch.Tensor             # (Ns,)  safe radius
    parent_expand0: torch.Tensor  # (Ns,)  top parent-expand bit at last sweep
    slab_cut0: torch.Tensor       # (Ns, S) cached cut
    root_expand0: torch.Tensor    # (Ns,)
    swept: torch.Tensor           # (Ns,)  ever swept

    @staticmethod
    def initial(Ns: int, S: int, device) -> "TemporalState":
        z = dict(device=device)
        return TemporalState(
            cam0=torch.zeros((Ns, 3), dtype=torch.float32, **z),
            rho=torch.zeros((Ns,), dtype=torch.float32, **z),
            parent_expand0=torch.zeros((Ns,), dtype=torch.bool, **z),
            slab_cut0=torch.zeros((Ns, S), dtype=torch.bool, **z),
            root_expand0=torch.zeros((Ns,), dtype=torch.bool, **z),
            swept=torch.zeros((Ns,), dtype=torch.bool, **z),
        )

    @staticmethod
    def initial_batched(Ns: int, S: int, B: int, device) -> "TemporalState":
        """B fresh states stacked on a leading client axis (unswept, so every
        client's first search is a full sweep)."""
        return pytree.tree_map(lambda a: a.expand((B,) + a.shape).clone(),
                               TemporalState.initial(Ns, S, device))


@dataclasses.dataclass(frozen=True)
class SlabTables:
    """The slab attribute tables, gathered once per tree: the pooled service
    gathers its (client, slab) pairs from these every sync."""

    mu: torch.Tensor        # (Ns, S, 3)
    size: torch.Tensor      # (Ns, S)
    parent: torch.Tensor    # (Ns, S) int32
    level: torch.Tensor     # (Ns, S) int32
    is_leaf: torch.Tensor   # (Ns, S) bool
    valid: torch.Tensor     # (Ns, S) bool

    @staticmethod
    def from_tree(tree: LodTree, mesh=None) -> "SlabTables":
        """`mesh` (a serving mesh, `repro_torch.sharding.fleet`) keeps this
        rank's block of every table on its leading Ns axis over `slabs`;
        an indivisible Ns, or no mesh, keeps them whole."""
        tables = SlabTables(mu=tree.slab_mu(), size=tree.slab_size(),
                            parent=tree.slab_parent, level=tree.slab_level,
                            is_leaf=tree.slab_is_leaf, valid=tree.slab_valid)
        return shard_slab_tables(mesh, tables)


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------


def top_sweep(tree: LodTree, cam_pos: torch.Tensor, focal, tau
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Level-major sweep of the top-tree. Returns (expand, in_cut), both (T,)."""
    m = tree.meta
    dist = slab_dist(tree.top_mu(), cam_pos)
    gt = tree.top_size() * focal / torch.clamp_min(dist, _EPS_DIST) > tau
    expand = torch.zeros((m.T,), dtype=torch.bool, device=tree.device)
    in_cut = torch.zeros((m.T,), dtype=torch.bool, device=tree.device)
    offs = m.top_level_offsets
    for lv in range(m.P):
        lo, hi = offs[lv], offs[lv + 1]
        if lv == 0:
            pe = torch.ones((hi - lo,), dtype=torch.bool, device=tree.device)
        else:
            pe = expand[tree.top_parent[lo:hi].long()]
        expand[lo:hi] = pe & gt[lo:hi]
        in_cut[lo:hi] = pe & (~gt[lo:hi] | tree.top_is_leaf[lo:hi])
    return expand, in_cut


# The reference's per-slab sweep, written batched over a leading slab axis:
# (in_cut, root_expand, rho). It is K1's plain version.
_slab_sweep_one = slab_sweep_plain


def _slab_sweep_all(tree: LodTree, cam_pos, focal, tau, root_parent_expand):
    """Every slab through K1 (the plain version for CPU tensors)."""
    return lod_slab_sweep(tree.slab_mu(), tree.slab_size(), tree.slab_parent,
                          tree.slab_level, tree.slab_is_leaf, tree.slab_valid,
                          root_parent_expand, cam_pos, focal, tau,
                          max_depth=tree.meta.slab_max_depth)


def _root_parent_expand(tree: LodTree, top_expand: torch.Tensor) -> torch.Tensor:
    """Exact parent-expand bit for every slab root."""
    if tree.meta.P == 0:
        return torch.ones((tree.meta.Ns,), dtype=torch.bool, device=tree.device)
    return top_expand[tree.slab_root_parent_top.long()]


def _cam(tree: LodTree, cam_pos) -> torch.Tensor:
    if torch.is_tensor(cam_pos):
        return cam_pos.to(device=tree.device, dtype=torch.float32).reshape(3)
    return torch.tensor(np.asarray(cam_pos, np.float32), device=tree.device).reshape(3)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def full_search(tree: LodTree, cam_pos, focal: float, tau: float
                ) -> Tuple[CutResult, TemporalState]:
    """Initial-frame traversal; also (re)initializes the temporal state."""
    m = tree.meta
    cam_pos = _cam(tree, cam_pos)
    top_expand, top_cut = top_sweep(tree, cam_pos, focal, tau)
    rpe = _root_parent_expand(tree, top_expand)
    slab_cut, root_expand, rho = _slab_sweep_all(tree, cam_pos, focal, tau, rpe)
    dev = tree.device
    cut = CutResult(
        top_cut=top_cut, slab_cut=slab_cut, root_expand=root_expand,
        resweep=torch.ones((m.Ns,), dtype=torch.bool, device=dev),
        nodes_touched=torch.tensor(m.T + m.Ns * m.S, dtype=torch.int32, device=dev),
    )
    state = TemporalState(
        cam0=cam_pos.expand(m.Ns, 3).clone(), rho=rho, parent_expand0=rpe,
        slab_cut0=slab_cut, root_expand0=root_expand,
        swept=torch.ones((m.Ns,), dtype=torch.bool, device=dev),
    )
    return cut, state


def temporal_search(tree: LodTree, state: TemporalState, cam_pos,
                    focal: float, tau: float) -> Tuple[CutResult, TemporalState]:
    """Temporal-aware search: sweeps every slab through K1, then keeps the
    fresh result only for stale slabs. Exact against `full_search`."""
    m = tree.meta
    cam_pos = _cam(tree, cam_pos)
    top_expand, top_cut = top_sweep(tree, cam_pos, focal, tau)
    rpe = _root_parent_expand(tree, top_expand)

    moved = slab_dist(cam_pos, state.cam0)
    stale = (~state.swept) | (moved >= state.rho) | (rpe != state.parent_expand0)

    fresh_cut, fresh_root_expand, fresh_rho = _slab_sweep_all(
        tree, cam_pos, focal, tau, rpe)

    sel = stale[:, None]
    slab_cut = torch.where(sel, fresh_cut, state.slab_cut0)
    root_expand = torch.where(stale, fresh_root_expand, state.root_expand0)
    new_state = TemporalState(
        cam0=torch.where(sel, cam_pos[None, :], state.cam0),
        rho=torch.where(stale, fresh_rho, state.rho),
        parent_expand0=rpe,
        slab_cut0=slab_cut,
        root_expand0=root_expand,
        swept=torch.ones((m.Ns,), dtype=torch.bool, device=tree.device),
    )
    cut = CutResult(
        top_cut=top_cut, slab_cut=slab_cut, root_expand=root_expand,
        resweep=stale,
        nodes_touched=(m.T + stale.sum() * m.S).to(torch.int32),
    )
    return cut, new_state


# -- batched multi-client search (leading axis = clients) ---------------------


def _broadcast_taus(tau, b: int, device) -> torch.Tensor:
    """A scalar τ or a (B,) per-client vector, as (B,) float32."""
    return torch.as_tensor(tau, dtype=torch.float32, device=device).expand(b).contiguous()


def batched_temporal_search(tree: LodTree, states: TemporalState, cam_positions,
                            focal: float, tau) -> Tuple[CutResult, TemporalState]:
    """`temporal_search` for B clients on one tree (states' leaves lead with
    B; cam_positions (B, 3); `tau` a scalar or a (B,) foveated vector). Each
    client's slice equals its own `temporal_search`; on the card each client
    sweeps its slabs through K1."""
    cams = torch.as_tensor(cam_positions, dtype=torch.float32, device=tree.device)
    taus = _broadcast_taus(tau, cams.shape[0], tree.device).tolist()
    out = [temporal_search(tree, pytree.take(states, b), cams[b], focal, taus[b])
           for b in range(cams.shape[0])]
    cuts, new_states = zip(*out)
    return pytree.stack(cuts), pytree.stack(new_states)


def batched_cut_mask(cut: CutResult, tree: LodTree) -> torch.Tensor:
    """(B, N_pad) global cut masks from a batched CutResult."""
    b = cut.top_cut.shape[0]
    return torch.cat([cut.top_cut, cut.slab_cut.reshape(b, -1)], dim=1)


# -- host-driven variant --------------------------------------------------------


def pow2_bucket(n: int, cap: int) -> int:
    """Round `n` up to a power of two, clamped to [1, cap]. The one bucket
    policy of every host-driven scheduler: the hybrid stale-slab sweep, the
    service's pooled (client, slab) pairs and Δ-union width, and the fleet's
    pooled raster tiles."""
    b = 1 << int(np.ceil(np.log2(max(n, 1))))
    return max(1, min(b, cap))


def _top_and_staleness(tree: LodTree, state: TemporalState, cam_pos, focal, tau):
    top_expand, top_cut = top_sweep(tree, cam_pos, focal, tau)
    rpe = _root_parent_expand(tree, top_expand)
    moved = slab_dist(cam_pos, state.cam0)
    stale = (~state.swept) | (moved >= state.rho) | (rpe != state.parent_expand0)
    return top_cut, rpe, stale


def batched_top_and_staleness(tree: LodTree, states: TemporalState, cam_positions,
                              focal: float, tau, active=None):
    """The cheap phase of the hybrid search for B clients: the exact top-tree
    sweep and the per-slab staleness test. `tau` is a scalar or a (B,)
    vector. Returns (top_cut (B,T), rpe (B,Ns), stale (B,Ns)). `active` (B,)
    bool masks a slot's staleness to nothing, so it adds no pooled pairs."""
    cams = torch.as_tensor(cam_positions, dtype=torch.float32, device=tree.device)
    taus = _broadcast_taus(tau, cams.shape[0], tree.device).tolist()
    out = [_top_and_staleness(tree, pytree.take(states, b), cams[b], focal, taus[b])
           for b in range(cams.shape[0])]
    top_cut, rpe, stale = (torch.stack(x) for x in zip(*out))
    if active is not None:
        stale = stale & active[:, None]
    return top_cut, rpe, stale


def predicted_stale_counts(tree: LodTree, states: TemporalState, cam_positions,
                           focal: float, tau, active=None) -> torch.Tensor:
    """(B,) int32 — the slabs each client would resweep if it synced now at
    `cam_positions`: the staleness test of `batched_top_and_staleness`, with
    nothing written back (the deadline scheduler prices a tick with it).
    Slots masked out by `active` predict zero."""
    _top, _rpe, stale = batched_top_and_staleness(tree, states, cam_positions, focal,
                                                  tau, active)
    return stale.sum(1).to(torch.int32)


def sweep_slab_camera_pairs(slab_mu, slab_size, slab_parent, slab_level, slab_is_leaf,
                            slab_valid, rpe_sel, cam_sel, focal, tau, max_depth: int):
    """Sweep K (slab, camera) pairs, each at its own camera (K, 3) and τ (a
    scalar or (K,)): (in_cut (K,S), root_expand (K,), rho (K,)). The plain
    version of K6, which the pooled service launches on the same pairs."""
    taus = _broadcast_taus(tau, slab_size.shape[0], slab_size.device)
    return pair_sweep_plain(slab_mu, slab_size, slab_parent, slab_level, slab_is_leaf,
                            slab_valid, rpe_sel, cam_sel, focal, taus,
                            max_depth=max_depth)


def _apply_slab_updates(slab_cut, root_expand, rho, cam0, sel, f_cut, f_rexp, f_rho,
                        cam_pos):
    """Scatter swept slabs into (copies of) the state; repeat-padded
    duplicates write identical values."""
    return (slab_cut.index_put((sel,), f_cut), root_expand.index_put((sel,), f_rexp),
            rho.index_put((sel,), f_rho),
            cam0.index_put((sel,), cam_pos[None, :].expand(sel.shape[0], 3)))


def temporal_search_hybrid(tree: LodTree, state: TemporalState, cam_pos,
                           focal: float, tau: float) -> Tuple[CutResult, TemporalState]:
    """Host-driven temporal search: only the stale slabs are gathered and
    swept (through K1), in a pow2 bucket repeat-padded with earlier stale
    slabs. The same result as `temporal_search`."""
    m = tree.meta
    cam_pos = _cam(tree, cam_pos)
    top_cut, rpe, stale = _top_and_staleness(tree, state, cam_pos, focal, tau)
    idx = torch.nonzero(stale, as_tuple=True)[0]
    n_stale = int(idx.numel())
    slab_cut, root_expand, rho, cam0 = (state.slab_cut0, state.root_expand0,
                                        state.rho, state.cam0)
    if n_stale > 0:
        bucket = pow2_bucket(n_stale, m.Ns)
        sel = idx[torch.arange(bucket, device=idx.device) % n_stale]
        f_cut, f_rexp, f_rho = lod_slab_sweep(
            tree.slab_mu()[sel], tree.slab_size()[sel], tree.slab_parent[sel],
            tree.slab_level[sel], tree.slab_is_leaf[sel], tree.slab_valid[sel],
            rpe[sel], cam_pos, focal, tau, max_depth=m.slab_max_depth)
        slab_cut, root_expand, rho, cam0 = _apply_slab_updates(
            slab_cut, root_expand, rho, cam0, sel, f_cut, f_rexp, f_rho, cam_pos)
    dev = tree.device
    new_state = TemporalState(cam0=cam0, rho=rho, parent_expand0=rpe, slab_cut0=slab_cut,
                              root_expand0=root_expand,
                              swept=torch.ones((m.Ns,), dtype=torch.bool, device=dev))
    cut = CutResult(top_cut=top_cut, slab_cut=slab_cut, root_expand=root_expand,
                    resweep=stale,
                    nodes_touched=torch.tensor(m.T + n_stale * m.S, dtype=torch.int32,
                                               device=dev))
    return cut, new_state


# ---------------------------------------------------------------------------
# cut extraction
# ---------------------------------------------------------------------------


def compact_ids(mask: torch.Tensor, budget: int) -> torch.Tensor:
    """The first `budget` set positions of `mask`, ascending, padded with -1
    (int32)."""
    (ids,) = torch.nonzero(mask, as_tuple=True)
    out = torch.full((budget,), -1, dtype=torch.int32, device=mask.device)
    k = min(budget, ids.numel())
    out[:k] = ids[:k].to(torch.int32)
    return out


def cut_gids(cut: CutResult, tree: LodTree, budget: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact the cut mask to (budget,) sorted global ids padded with -1.

    Returns (gids, count, overflow)."""
    mask = cut.mask(tree)
    count = mask.sum().to(torch.int32)
    return compact_ids(mask, budget), count, count > budget
