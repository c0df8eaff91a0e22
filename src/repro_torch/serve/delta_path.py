"""Encode-once fleet Δcut delivery (cross-client payload dedup). Port of
`repro.serve.delta_path`.

`build_delta_batch` takes the fleet-union of one sync's Δcut masks, ranks
its rows coarse-LoD-first (tree depth ascending, then fleet requester count
descending, then gid), ships the top `width` ranks as `page_size`-row
priority pages, and encodes the shipped rows once: one `compression.encode`
(K5 on the card) whatever the client count. Each client's payload is a mask
over the shared stream (`DeltaBatch.ref_mask`), in ascending-gid order, so
it decodes bit for bit like its own per-client stream (`encode_per_client`,
the tests' oracle). Rows a tight budget or a client's row allowance leave
behind come back in `deferred`, for the service to fold into the next
sync's union. `page_checksums` and `lost_row_mask` are the host-side wire
framing of the NACK path: a page whose checksum fails on the client is
named back, and its rows return to the client's debt.

Under a serving mesh (`repro_torch.sharding.fleet`) the masks are one
client shard's rows. The union and its requester counts are an all-reduce
over `clients` (so the union comes back the same on every shard), a
client's first-requester test takes the counts of the shards before it,
and the union's rows split over `slabs` for the encode (the payload stays
split until a decode gathers it). Each client's ref rows stay on its shard.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import compression as comp
from repro_torch.core import lod_search as ls
from repro_torch.core.gaussians import Gaussians
from repro_torch.sharding import fleet as shd

_PRIO_PAD = 2**31 - 1  # non-members sort after every real row


@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """One sync's encode-once fleet payload.

    union_gids: (U,) int32 — ascending gids of the rows shipped this sync,
                -1 padded (U is the pow2 stream width, at most the budget)
    n_union:    () int32 — the true union size (shipped + deferred)
    n_shipped:  () int32 — rows in this sync's stream
    payload:    EncodedGaussians with U rows (rows past n_shipped are padding)
    ref_mask:   (B, U) bool — stream rows client b ingests this sync
    delivered:  (B, N) bool — node-indexed view of ref_mask
    deferred:   (B, N) bool — rows client b wanted that did not ship to it
    client_overflow: (B,) bool — client b has a deferred row
    client_pages: (B,) int32 — priority pages client b pulled rows from
    pages:      () int32 — priority pages in the stream
    row_page:   (U,) int32 — the priority page of each wire-order row (-1 pad)
    overflow:   () bool — some row was deferred somewhere in the fleet
    payload_shards: the union rows `payload` is split into over the mesh's
                `slabs` axis (this rank holds one block; 1: all of them)
    """

    union_gids: torch.Tensor
    n_union: torch.Tensor
    n_shipped: torch.Tensor
    payload: comp.EncodedGaussians
    ref_mask: torch.Tensor
    delivered: torch.Tensor
    deferred: torch.Tensor
    client_overflow: torch.Tensor
    client_pages: torch.Tensor
    pages: torch.Tensor
    row_page: torch.Tensor
    overflow: torch.Tensor
    payload_shards: int = 1

    @property
    def n_clients(self) -> int:
        return self.ref_mask.shape[0]


def _union_mask(delta_masks: torch.Tensor):
    union = delta_masks.any(0)
    return union, union.sum().to(torch.int32)


def _union_refs(wanted: torch.Tensor, union: torch.Tensor, priority: torch.Tensor,
                allowance: torch.Tensor, width: int, page_size: int, req=None):
    """Priority-ordered page selection of one sync's union: the rows ranked
    by (priority asc, requester count desc, gid asc), the top `width` ranks
    shipped in ascending-gid wire order, each client's ingest capped by its
    allowance in priority order, and the page accounting. `req` is the
    fleet's (N,) int32 requester counts where `wanted` is one shard of it."""
    b, n = wanted.shape
    dev = wanted.device
    if req is None:
        req = wanted.sum(0).to(torch.int32)
    k1 = torch.where(union, priority.to(torch.int32),
                     torch.full((n,), _PRIO_PAD, dtype=torch.int32, device=dev))
    # lexicographic order by stable sorts from the last key to the first;
    # the gid key is the identity order the first sort starts from
    by_req = torch.argsort(-req, stable=True)
    by_rank = by_req[torch.argsort(k1[by_req], stable=True)]
    take = by_rank[:width]
    valid = k1[take] != _PRIO_PAD
    n_shipped = valid.sum().to(torch.int32)

    ref_rank = wanted[:, take] & valid[None, :]
    cum = torch.cumsum(ref_rank.to(torch.int32), dim=1)
    ingest = ref_rank & (cum <= allowance[:, None])

    n_pages = max(1, -(-width // page_size))
    page_of = torch.arange(width, dtype=torch.int64, device=dev) // page_size
    pages_hit = torch.zeros((b, n_pages), dtype=torch.int32, device=dev).index_add_(
        1, page_of, ingest.to(torch.int32)) > 0
    client_pages = pages_hit.sum(1).to(torch.int32)
    pages = ((n_shipped + page_size - 1) // page_size).to(torch.int32)

    # `take` holds distinct gids, so the scatter is a plain assignment
    delivered = torch.zeros((b, n), dtype=torch.bool, device=dev)
    delivered[:, take] = ingest
    deferred = wanted & ~delivered
    client_overflow = deferred.any(1)

    order = torch.argsort(torch.where(valid, take, torch.full_like(take, n)), stable=True)
    gids = torch.where(valid[order], take[order], -1).to(torch.int32)
    ref = ingest[:, order]
    row_page = torch.where(valid[order], page_of[order], -1).to(torch.int32)
    return (gids, ref, delivered, deferred, client_overflow, client_pages, pages,
            n_shipped, row_page)


def build_delta_batch(gaussians: Gaussians, codec: comp.Codec,
                      delta_masks: torch.Tensor, budget: int, active=None, *,
                      pending=None, priority=None, allowance=None,
                      page_size=None, mesh=None, n_shards: int = 1) -> DeltaBatch:
    """Encode one sync's fleet Δcut once, paged under the budget.

    delta_masks: (B, N) bool — the batched `SyncPlan.delta_data`.
    budget: cap on the encoded stream (rows). A larger union is not
    truncated: the coarsest ranks ship now and the rest comes back in
    `deferred`. pending: (B, N) bool debt from earlier syncs, unioned into
    this sync's wanted set. priority: (N,) int32 rank key, lower ships first
    (default 0 everywhere). allowance: (B,) int32 per-client row cap
    (default unlimited). page_size: rows per priority page (default one page
    spanning the stream). active: (B,) bool — an inactive slot adds no rows.

    The stream width is the pow2 bucket of the true union size, one scalar
    read on the host, so the encode tracks the sync's unique Gaussians.

    `mesh` with `n_shards` > 1: the masks are this rank's block of
    `n_shards` client shards, and the union's counts are all-reduced over
    `clients`. With a `slabs` axis that divides the stream width, this rank
    encodes its block of the union's rows (`payload_shards`)."""
    if active is not None:
        delta_masks = delta_masks & active[:, None]
        if pending is not None:
            pending = pending & active[:, None]
    wanted = delta_masks if pending is None else delta_masks | pending
    b, n = wanted.shape
    req = None
    if n_shards > 1:
        counts = wanted.sum(0).to(shd.count_dtype(b * n_shards))
        req = shd.all_reduce(mesh, "clients", counts).to(torch.int32)
        union = req > 0
        n_union = union.sum().to(torch.int32)
    else:
        union, n_union = _union_mask(wanted)
    width = ls.pow2_bucket(int(n_union), budget)
    dev = wanted.device
    if priority is None:
        priority = torch.zeros((n,), dtype=torch.int32, device=dev)
    allow = (torch.full((b,), width, dtype=torch.int32, device=dev) if allowance is None
             else torch.as_tensor(allowance, dtype=torch.int32, device=dev))
    psize = width if page_size is None else max(1, min(int(page_size), width))
    (gids, ref, delivered, deferred, client_overflow, client_pages, pages, n_shipped,
     row_page) = _union_refs(wanted, union, priority, allow, width, psize, req=req)
    split = shd.slab_shards(mesh, width)
    lo, hi = shd.block(mesh, "slabs", split, width)
    payload = comp.encode_rows(codec, gaussians, gids[lo:hi])
    overflow = client_overflow.any()
    if n_shards > 1:
        overflow = shd.all_reduce(mesh, "clients", overflow, op=dist.ReduceOp.MAX)
    return DeltaBatch(union_gids=gids, n_union=n_union, n_shipped=n_shipped,
                      payload=payload, ref_mask=ref, delivered=delivered,
                      deferred=deferred, client_overflow=client_overflow,
                      client_pages=client_pages, pages=pages, row_page=row_page,
                      overflow=overflow, payload_shards=split)


def replicate_payload(mesh, batch: DeltaBatch) -> comp.EncodedGaussians:
    """The whole encoded union from the `slabs` blocks of a split payload
    (an all-gather over `slabs`; the payload itself when it is whole)."""
    return shd.replicate_fleet(mesh, batch.payload, batch.payload_shards, axis="slabs")


def decode_client(codec: comp.Codec, batch: DeltaBatch, sh_k: int,
                  client: int) -> Tuple[torch.Tensor, Gaussians]:
    """One client's decoded Δcut from the shared stream: (ids (U,) int32 —
    its gids, -1 where the union row is not its — and the decoded union
    rows). Scattering rows where ids >= 0 into the client's store gives what
    its own per-client stream would have."""
    dec = comp.decode(codec, batch.payload, sh_k)
    ids = torch.where(batch.ref_mask[client], batch.union_gids, -1)
    return ids, dec


def encode_per_client(gaussians: Gaussians, codec: comp.Codec,
                      delta_masks: torch.Tensor, budget: int):
    """The reference path: each client's Δcut encoded on its own. Returns,
    per client, (ids (budget,) int32 ascending, -1 padded; EncodedGaussians;
    overflow () bool — the Δ exceeded the budget and was truncated)."""
    out = []
    for b in range(delta_masks.shape[0]):
        count = delta_masks[b].sum().to(torch.int32)
        ids = ls.compact_ids(delta_masks[b], budget)
        out.append((ids, comp.encode_rows(codec, gaussians, ids), count > budget))
    return out


# ---------------------------------------------------------------------------
# page integrity (loss detection + NACK retransmit)
# ---------------------------------------------------------------------------

# Knuth's multiplicative constant mixes each gid before the per-page sum, so
# two gids swapped between pages flip both checksums; the +1 makes the row
# count part of the sum (a gid-0 row would otherwise add nothing)
_CKSUM_MIX = np.uint32(2654435761)


def page_checksums(batch: DeltaBatch) -> np.ndarray:
    """(pages,) uint32 — each priority page's checksum, carried in its wire
    header (`manager.PAGE_HEADER_BYTES` budgets the 4 bytes): the wraparound
    sum of its rows' mixed gids, order-independent, computed on the host in
    numpy uint32 arithmetic."""
    row_page = batch.row_page.cpu().numpy()
    gids = batch.union_gids.cpu().numpy()
    n_pages = int(batch.pages)
    out = np.zeros((max(n_pages, 1),), np.uint32)
    rows = row_page >= 0
    with np.errstate(over="ignore"):
        mix = gids[rows].astype(np.uint32) * _CKSUM_MIX + np.uint32(1)
    np.add.at(out, row_page[rows], mix)
    return out[:n_pages]


def lost_row_mask(batch: DeltaBatch, client: int, lost_pages) -> np.ndarray:
    """(N,) bool — the rows slot `client` ingested this sync from the given
    priority pages: what a NACK naming those pages re-queues. Rows of a lost
    page the client did not take are not its loss."""
    row_page = batch.row_page.cpu().numpy()
    gids = batch.union_gids.cpu().numpy()
    ref = batch.ref_mask[client].cpu().numpy()
    lost = np.asarray(sorted(set(int(p) for p in lost_pages)), np.int64)
    rows = ref & np.isin(row_page, lost) & (gids >= 0)
    out = np.zeros((batch.delivered.shape[1],), bool)
    out[gids[rows]] = True
    return out


def first_owner_counts(delta_masks: torch.Tensor, mesh=None,
                       n_shards: int = 1) -> torch.Tensor:
    """(B,) int32 — per client, its Δ rows for which it is the fleet's first
    requester (lowest slot). Sums to the sync's unique Gaussians. With
    `n_shards` > 1 the masks are this rank's client shard, and the counts of
    the shards before it come from an all-gather over `clients`."""
    counts = torch.cumsum(delta_masks.to(torch.int32), dim=0)
    if n_shards > 1:
        cols = delta_masks.sum(0).to(shd.count_dtype(delta_masks.shape[0]))
        every = shd.all_gather_blocks(mesh, "clients", [cols])[0]
        counts = counts + every[:mesh.index("clients")].to(torch.int32).sum(0)
    first = delta_masks & (counts == 1)
    return first.sum(1).to(torch.int32)
