"""Runtime Gaussian management (paper §4.3).

Port of `repro.core.manager`. The cloud keeps a management table of what the
client holds; per LoD sync it transmits only the Δcut (Gaussians newly
needed and not cached) and the cut-membership delta (ids). Both sides run
the same reuse-window eviction rule on identical inputs, so the tables stay
consistent without eviction traffic. State is a dense bitmap over padded
node ids.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.lod_search import compact_ids
from repro_torch.numerics import xla_row_sum

ID_BYTES = 4          # plain 32-bit ids on the wire
ID_BYTES_DELTA = 2    # delta-coded ids (sorted ascending) — model
SYNC_HEADER_BYTES = 64
POSE_UPLINK_BYTES = 100  # client → cloud pose per frame (paper §2.1)
PAGE_HEADER_BYTES = 16  # per priority page of the paged multicast stream

_NEVER = -(2**30)


@dataclasses.dataclass(frozen=True)
class ManagerState:
    """Cloud-side management table (the client mirrors it deterministically)."""

    client_has: torch.Tensor   # (N,) bool — which Gaussians the client stores
    last_used: torch.Tensor    # (N,) int32 — sync index when last in a cut
    cut_prev: torch.Tensor     # (N,) bool — previous cut

    @staticmethod
    def initial(n: int, device) -> "ManagerState":
        return ManagerState(
            client_has=torch.zeros((n,), dtype=torch.bool, device=device),
            last_used=torch.full((n,), _NEVER, dtype=torch.int32, device=device),
            cut_prev=torch.zeros((n,), dtype=torch.bool, device=device),
        )


@dataclasses.dataclass(frozen=True)
class SyncPlan:
    """What one LoD sync transmits (masks over node ids + byte accounting)."""

    delta_data: torch.Tensor    # (N,) bool — Δcut: attribute payload to send
    cut_add: torch.Tensor       # (N,) bool — ids entering the render queue
    cut_remove: torch.Tensor    # (N,) bool — ids leaving the render queue
    evicted: torch.Tensor       # (N,) bool — dropped by the shared reuse rule
    n_delta: torch.Tensor       # () int32
    n_resident: torch.Tensor    # () int32 — client occupancy after the sync

    def wire_bytes(self, bytes_per_gaussian: float) -> torch.Tensor:
        ids = (self.cut_add.sum() + self.cut_remove.sum()).to(torch.float32)
        return (self.n_delta.to(torch.float32) * bytes_per_gaussian
                + ids * ID_BYTES_DELTA + SYNC_HEADER_BYTES)


def cloud_sync(state: ManagerState, cut_mask: torch.Tensor, t,
               w_star: int) -> Tuple[ManagerState, SyncPlan]:
    """One management-table update on the cloud (paper Fig. 9, left).

    t is the sync counter; w_star the shared reuse threshold (in syncs).
    Leaves may lead with a client axis (B, N), with t then (B, 1)."""
    delta_data = cut_mask & ~state.client_has
    cut_add = cut_mask & ~state.cut_prev
    cut_remove = state.cut_prev & ~cut_mask

    t = torch.as_tensor(t, dtype=torch.int32, device=cut_mask.device)
    last_used = torch.where(cut_mask, t, state.last_used)
    has = state.client_has | cut_mask
    evicted = has & ((t - last_used) > w_star)
    has = has & ~evicted

    new_state = ManagerState(client_has=has, last_used=last_used, cut_prev=cut_mask)
    plan = SyncPlan(
        delta_data=delta_data, cut_add=cut_add, cut_remove=cut_remove,
        evicted=evicted,
        n_delta=delta_data.sum(-1).to(torch.int32),
        n_resident=has.sum(-1).to(torch.int32),
    )
    return new_state, plan


@dataclasses.dataclass(frozen=True)
class ClientState:
    """Client-side mirror: rebuilds the same table from the wire data only."""

    has: torch.Tensor
    last_used: torch.Tensor
    cut: torch.Tensor  # current render queue (bool mask)

    @staticmethod
    def initial(n: int, device) -> "ClientState":
        return ClientState(
            has=torch.zeros((n,), dtype=torch.bool, device=device),
            last_used=torch.full((n,), _NEVER, dtype=torch.int32, device=device),
            cut=torch.zeros((n,), dtype=torch.bool, device=device),
        )


def client_sync(state: ClientState, delta_data: torch.Tensor, cut_add: torch.Tensor,
                cut_remove: torch.Tensor, t: int, w_star: int) -> ClientState:
    """Apply one received sync. Inputs are exactly what came off the wire."""
    cut = (state.cut | cut_add) & ~cut_remove
    has = state.has | delta_data
    last_used = torch.where(cut, torch.tensor(t, dtype=torch.int32, device=cut.device),
                            state.last_used)
    has = has | cut
    has = has & ((t - last_used) <= w_star)
    return ClientState(has=has, last_used=last_used, cut=cut)


def gather_payload(tree_gaussians, delta_mask: torch.Tensor, budget: int):
    """Compact Δcut ids (sorted, -1 padded) for the payload gather."""
    return compact_ids(delta_mask, budget), delta_mask.sum().to(torch.int32)


# ---------------------------------------------------------------------------
# batched multi-client tables
# ---------------------------------------------------------------------------


def batched_cloud_sync(states: ManagerState, cut_masks: torch.Tensor,
                       ts: torch.Tensor, w_star: int) -> Tuple[ManagerState, SyncPlan]:
    """`cloud_sync` for B clients on one tree: leaves (B, N), cut_masks
    (B, N), ts (B,). Each client's slice equals its own `cloud_sync`."""
    return cloud_sync(states, cut_masks, ts[:, None], w_star)


def batched_wire_bytes(plan: SyncPlan, bytes_per_gaussian: float, *,
                       shared_payload: bool = False, active=None, delivered=None,
                       client_pages=None, share=None) -> torch.Tensor:
    """(B,) float32 downlink bytes of each client for a batched SyncPlan.

    shared_payload=False — the unicast format: each client receives its own
    encoded Δcut (payload ∝ its n_delta; Δ ids implicit).
    shared_payload=True — the encode-once fleet format
    (`repro_torch.serve.delta_path`): the union Δcut is multicast once as
    [union gids + encoded rows], and each shared row's cost (attributes +
    its id) is split evenly across the clients that ingested it, so the
    per-client figures sum to the fleet total. `delivered` (B, N) is what
    each client actually ingested this sync (default: every requested row);
    `client_pages` (B,) adds PAGE_HEADER_BYTES per priority page pulled.

    `active` (B,) bool: an inactive slot is charged nothing, header
    included, and is left out of the requester split. `share` is the (N,)
    int32 requester count of each row over the whole fleet, where the B
    rows here are one shard of it (default: their own column sums).

    The float32 operations and the row sums' order are the reference's on
    its CPU backend (`numerics.xla_row_sum`), so the bytes are the same
    bits."""
    delta = plan.delta_data if delivered is None else delivered
    if active is not None:
        delta = delta & active[:, None]
    ids = (plan.cut_add.sum(1) + plan.cut_remove.sum(1)).to(torch.float32)
    base = ids * ID_BYTES_DELTA + SYNC_HEADER_BYTES
    if not shared_payload:
        out = plan.n_delta.to(torch.float32) * bytes_per_gaussian + base
    else:
        if share is None:
            share = delta.sum(0).to(torch.int32)
        one = torch.ones((), dtype=torch.float32, device=delta.device)
        inv = one / torch.clamp_min(share, 1).to(torch.float32)
        frac = xla_row_sum(torch.where(delta, inv[None, :], torch.zeros_like(one)))
        out = frac * (bytes_per_gaussian + ID_BYTES_DELTA) + base
        if client_pages is not None:
            out = out + client_pages.to(torch.float32) * PAGE_HEADER_BYTES
    if active is not None:
        out = torch.where(active, out, torch.zeros_like(out))
    return out
