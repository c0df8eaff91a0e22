"""The management table of one client (paper §4.3) and the bytes a sync
sends, as the configuration states them.

A sync at index t with cut C: the Δ rows are C less what the client holds;
the ids entering and leaving the render queue are C less the previous cut
and the previous cut less C; a row is held while it was in a cut within the
last `w_star` syncs. Wire bytes (all in float64):
  one client:  Δ · bytes_per_gaussian + (adds + removes) · 2 + 64
  a fleet:     Σ over its Δ rows of 1 / (clients that want the row) ·
               (bytes_per_gaussian + 2) + (adds + removes) · 2 + 64
               + 16 a priority page it takes rows from,
where the fleet's union is ranked by tree depth, then by how many clients
want a row (more first), then by row id, and cut into pages of `page_size`
rows. A non-sync frame sends the 100-byte pose."""

from __future__ import annotations

import torch

ID_BYTES = 2
HEADER_BYTES = 64
PAGE_HEADER_BYTES = 16
POSE_BYTES = 100


def bytes_per_gaussian(k_codes: int) -> int:
    """The compressed wire row: position, log-scale and opacity at 16 bits,
    the quaternion at 16 bits a component, the SH DC at fp16 and one VQ code."""
    code_bytes = max(1, -(-max(k_codes - 1, 1).bit_length() // 8))
    return 3 * 2 + code_bytes + 3 * 2 + 3 * 2 + 4 * 2 + 2


class Client:
    def __init__(self, n: int, device):
        self.has = torch.zeros(n, dtype=torch.bool, device=device)
        self.last = torch.full((n,), -(2**40), dtype=torch.int64, device=device)
        self.prev = torch.zeros(n, dtype=torch.bool, device=device)

    def sync(self, cut: torch.Tensor, t: int, w_star: int):
        """(Δ mask, ids added + removed) of sync t."""
        delta = cut & ~self.has
        moved = int((cut & ~self.prev).sum()) + int((self.prev & ~cut).sum())
        self.last = torch.where(cut, t, self.last)
        self.has = (self.has | cut) & ((t - self.last) <= w_star)
        self.prev = cut
        return delta, moved


def unicast_bytes(n_delta: int, moved: int, bpg: int) -> float:
    return float(n_delta) * bpg + moved * ID_BYTES + HEADER_BYTES


def fleet_bytes(deltas: torch.Tensor, moved, bpg: int, level_of_row: torch.Tensor,
                page_size: int) -> list:
    """Each client's bytes of one fleet sync; `deltas` (B, N) bool."""
    req = deltas.sum(0)
    rows = torch.nonzero(req > 0, as_tuple=True)[0]
    key = (level_of_row[rows] * (deltas.shape[0] + 1) + (deltas.shape[0] - req[rows])) \
        * (deltas.shape[1] + 1) + rows
    ranked = rows[torch.argsort(key)]
    page = torch.empty(deltas.shape[1], dtype=torch.int64, device=deltas.device)
    page[ranked] = torch.arange(ranked.numel(), device=deltas.device) // page_size
    inv = 1.0 / req.clamp_min(1).double()
    out = []
    for b in range(deltas.shape[0]):
        mine = deltas[b]
        frac = float(inv[mine].sum())
        pages = int(torch.unique(page[mine]).numel())
        out.append(frac * (bpg + ID_BYTES) + moved[b] * ID_BYTES + HEADER_BYTES
                   + pages * PAGE_HEADER_BYTES)
    return out
