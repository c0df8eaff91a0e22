"""Fleet lifecycle: runtime client admission and eviction for the LoD
service. Port of `repro.serve.fleet`.

The service keeps every per-client leaf on a leading slot axis of pow2
capacity, and `FleetState` records which slots hold a live client, who
occupies them and how often each slot was recycled. An admitted slot starts
from the fresh per-client state (its first sync is a cold full sweep), an
evicted slot is reset at once, so a recycled slot is indistinguishable from
a fresh one. Inactive slots are frozen: the sync paths mask them out of the
staleness pool, the Δ-union, the wire accounting and the pooled raster, and
`freeze_inactive` keeps their state bitwise at its reset value. Capacity
grows to the next pow2 bucket when an admit finds no free slot
(`pad_slots`) and shrinks to the smallest bucket that holds the live
clients (`take_slots`). Under a serving mesh these act on the whole
fleet: `LodService` gathers its client blocks, grows or shrinks, and cuts
the blocks anew (`repro_torch.sharding.fleet`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
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


def fleet_admit_slot(fleet: FleetState, slot: int, client_id: int) -> FleetState:
    """Mark `slot` occupied by `client_id`; its generation counts one more
    admit."""
    dev = fleet.active.device
    cid = torch.tensor(int(client_id), dtype=torch.int32, device=dev)
    active, generation, ids = fleet.active.clone(), fleet.generation.clone(), \
        fleet.client_ids.clone()
    active[slot] = True
    generation[slot] += 1
    ids[slot] = cid
    return FleetState(active=active, generation=generation, client_ids=ids,
                      next_id=torch.maximum(fleet.next_id, cid + 1))


def fleet_evict_slot(fleet: FleetState, slot: int) -> FleetState:
    """Free `slot` (its generation is kept: it counts admits)."""
    active, ids = fleet.active.clone(), fleet.client_ids.clone()
    active[slot] = False
    ids[slot] = -1
    return FleetState(active=active, generation=fleet.generation, client_ids=ids,
                      next_id=fleet.next_id)


def fleet_grow(fleet: FleetState, new_capacity: int) -> FleetState:
    """Pad the slot array to `new_capacity` (the new slots free)."""
    c = fleet.capacity
    if new_capacity < c:
        raise ValueError(f"cannot shrink fleet {c} -> {new_capacity}")
    pad, dev = new_capacity - c, fleet.active.device
    return FleetState(
        active=torch.cat([fleet.active, torch.zeros((pad,), dtype=torch.bool, device=dev)]),
        generation=torch.cat([fleet.generation,
                              torch.zeros((pad,), dtype=torch.int32, device=dev)]),
        client_ids=torch.cat([fleet.client_ids,
                              torch.full((pad,), -1, dtype=torch.int32, device=dev)]),
        next_id=fleet.next_id)


def slots_mask(capacity: int, slots) -> np.ndarray:
    """(capacity,) bool participation mask selecting the given slot indices
    (the per-tick mask of `LodService.sync(participate=...)`). Out-of-range
    slots raise."""
    mask = np.zeros((int(capacity),), bool)
    idx = np.asarray(list(slots), np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= capacity):
        raise ValueError(f"slot indices outside [0, {capacity})")
    mask[idx] = True
    return mask


def fleet_mirror(fleet: FleetState):
    """Host copy of the fleet bookkeeping: (active (C,) bool, client_ids (C,)
    int64, next_id int), the control-plane mirror `LodService` keeps."""
    return (fleet.active.cpu().numpy().astype(bool),
            fleet.client_ids.cpu().numpy().astype(np.int64), int(fleet.next_id))


# ---------------------------------------------------------------------------
# slot surgery over batched pytrees (leaves lead with the slot axis)
# ---------------------------------------------------------------------------


def reset_slot(batched, fresh, slot: int):
    """Write the unbatched `fresh` tree into slot `slot` of (a copy of)
    `batched`."""

    def put(b, f):
        out = b.clone()
        out[slot] = f
        return out

    return pytree.tree_map(put, batched, fresh)


def pad_slots(batched, fresh, new_capacity: int):
    """Grow every leaf's leading slot axis to `new_capacity`, the new slots
    filled with the unbatched `fresh` values (a grown slot equals a reset
    one)."""

    def pad(b, f):
        extra = new_capacity - b.shape[0]
        if extra < 0:
            raise ValueError(f"cannot shrink axis {b.shape[0]} -> {new_capacity}")
        return torch.cat([b, f.to(b.device).expand((extra,) + tuple(f.shape))], dim=0)

    return pytree.tree_map(pad, batched, fresh)


def take_slots(batched, perm):
    """Gather slots `perm` from every leaf's leading slot axis: the dual of
    `pad_slots`. With `perm` = [live slots in order, then free ones], the
    free slots come out fresh, since an inactive slot is kept at its reset
    value."""
    def take(b):
        return b[torch.as_tensor(perm, dtype=torch.int64, device=b.device)]

    return pytree.tree_map(take, batched)


def fleet_shrink(fleet: FleetState, perm) -> FleetState:
    """Compact the bookkeeping to the slots in `perm` (live first, in slot
    order); `next_id` is kept, so ids stay monotone."""
    idx = torch.as_tensor(perm, dtype=torch.int64, device=fleet.active.device)
    return FleetState(active=fleet.active[idx], generation=fleet.generation[idx],
                      client_ids=fleet.client_ids[idx], next_id=fleet.next_id)


def freeze_inactive(new, old, active: torch.Tensor):
    """`new` for active slots and `old` for inactive ones, leafwise (active
    broadcasts over every trailing axis)."""

    def sel(n, o):
        return torch.where(active.reshape(active.shape + (1,) * (n.dim() - 1)), n, o)

    return pytree.tree_map(sel, new, old)
