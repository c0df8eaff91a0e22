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


def cloud_sync(state: ManagerState, cut_mask: torch.Tensor, t: int,
               w_star: int) -> Tuple[ManagerState, SyncPlan]:
    """One management-table update on the cloud (paper Fig. 9, left).

    t is the sync counter; w_star the shared reuse threshold (in syncs)."""
    delta_data = cut_mask & ~state.client_has
    cut_add = cut_mask & ~state.cut_prev
    cut_remove = state.cut_prev & ~cut_mask

    last_used = torch.where(cut_mask, torch.tensor(t, dtype=torch.int32,
                                                   device=cut_mask.device),
                            state.last_used)
    has = state.client_has | cut_mask
    evicted = has & ((t - last_used) > w_star)
    has = has & ~evicted

    new_state = ManagerState(client_has=has, last_used=last_used, cut_prev=cut_mask)
    plan = SyncPlan(
        delta_data=delta_data, cut_add=cut_add, cut_remove=cut_remove,
        evicted=evicted,
        n_delta=delta_data.sum().to(torch.int32),
        n_resident=has.sum().to(torch.int32),
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
