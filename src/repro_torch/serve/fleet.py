"""Fleet slot bookkeeping for the LoD service. Port of the part of
`repro.serve.fleet` that a fixed fleet needs.

The service keeps every per-client leaf on a leading slot axis, and
`FleetState` records which slots hold a live client. Inactive slots are
frozen: the sync paths mask them out of the staleness pool, the Δ-union,
the wire accounting and the pooled raster, and `freeze_inactive` keeps
their state bitwise at its reset value. (Admitting and evicting clients at
run time, and growing or shrinking the slot array, are not ported yet.)
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import pytree
from repro_torch.core import lod_search as ls

# host-side cap for capacity growth — pow2_bucket clamps to it
MAX_CAPACITY = 1 << 20


@dataclasses.dataclass(frozen=True)
class FleetState:
    """Slot-array bookkeeping for a capacity-C client fleet.

    active:     (C,) bool — slot currently holds a live client
    generation: (C,) int32 — admits into this slot so far
    client_ids: (C,) int32 — the stable client id in each slot, -1 when free
    next_id:    () int32 — next client id to hand out
    """

    active: torch.Tensor
    generation: torch.Tensor
    client_ids: torch.Tensor
    next_id: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.active.shape[0]


def fleet_init(capacity: int, n_active: int = 0, device=None) -> FleetState:
    """A fleet of `capacity` slots with the first `n_active` occupied by
    clients 0..n_active-1."""
    if not 0 <= n_active <= capacity:
        raise ValueError(f"n_active={n_active} outside [0, {capacity}]")
    idx = torch.arange(capacity, dtype=torch.int32, device=device)
    occupied = idx < n_active
    return FleetState(
        active=occupied,
        generation=occupied.to(torch.int32),
        client_ids=torch.where(occupied, idx, torch.full_like(idx, -1)),
        next_id=torch.tensor(n_active, dtype=torch.int32, device=device),
    )


def fleet_capacity(n: int) -> int:
    """The pow2 capacity bucket holding n clients."""
    return ls.pow2_bucket(n, MAX_CAPACITY)


def freeze_inactive(new, old, active: torch.Tensor):
    """`new` for active slots and `old` for inactive ones, leafwise (active
    broadcasts over every trailing axis)."""

    def sel(n, o):
        return torch.where(active.reshape(active.shape + (1,) * (n.dim() - 1)), n, o)

    return pytree.tree_map(sel, new, old)
