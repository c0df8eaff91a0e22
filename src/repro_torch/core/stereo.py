"""Stereo rasterization (paper §4.4): triangulation-based right-eye list
construction from the left-eye tile lists, with a k-way sorted merge.

Port of `repro.core.stereo`, plus the merge front end of the reference's
`kernels/ops.py` (`build_merge_sources`, `stereo_merge`). A splat in left
tile column c has disparity d = B·f/z, so a right tile column cx draws its
candidates only from left columns cx .. cx+n_cat−1. Each source list is
already depth-sorted (shared ranks), so the right list is a
duplicate-removing k-way merge: kernel K4 (`repro_torch.kernels.stereo_shift`)
on the card. `stereo_lists` is the reference's sort-based construction,
kept as an independent check of the merge.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.binning import TileLists, corner_r2
from repro_torch.core.projection import Splats
from repro_torch.kernels.stereo_shift import INF_RANK, stereo_merge_kernel

_I32_MAX = 2**31 - 1


def n_categories(max_disparity_px: float, tile: int) -> int:
    """Line-buffer rows needed (paper uses 4 at tile=4, max disparity 16)."""
    return int(max_disparity_px // tile) + 2


def _source_rows(left: TileLists, tiles_x_r: int, n_cat: int) -> torch.Tensor:
    """(tiles_y·tiles_x_r, n_cat, L) left-list rows feeding each right tile
    (columns past the widened grid are all -1)."""
    dev = left.lists.device
    tiles_x_w, tiles_y = left.tiles_x, left.tiles_y
    l_len = left.lists.shape[1]
    wide = left.lists.reshape(tiles_y, tiles_x_w, l_len)
    cols = (torch.arange(tiles_x_r, device=dev)[:, None]
            + torch.arange(n_cat, device=dev)[None, :])          # (tx_r, n_cat)
    src = wide[:, cols.clamp(0, tiles_x_w - 1), :]             # (ty, tx_r, n_cat, L)
    src = torch.where((cols < tiles_x_w)[None, :, :, None], src,
                      torch.full_like(src, -1))
    return src.reshape(tiles_y * tiles_x_r, n_cat, l_len)


def _include(src: torch.Tensor, s: Splats, tiles_x_r: int, tile: int):
    """SRU re-projection test for every candidate: does its shifted
    footprint reach this right tile? Returns (include, clamped ids)."""
    dev = src.device
    n = src.shape[0]
    g = src.clamp(0, s.m - 1).long()
    valid = src >= 0
    x_r = s.mean2d[g, 0] - s.disparity[g]
    ext_x = s.ext[g, 0]
    t = torch.arange(n, device=dev)
    extra = (1,) * (src.dim() - 1)
    lo = ((t % tiles_x_r) * tile).to(torch.float32).reshape(n, *extra)
    hi = lo + tile
    ylo = ((t // tiles_x_r) * tile).to(torch.float32).reshape(n, *extra)
    include = valid & (x_r + ext_x >= lo) & (x_r - ext_x <= hi)
    r2 = corner_r2(s.conic, s.opacity)[g]
    y_r = s.mean2d[g, 1]
    dx = torch.clamp_min(torch.maximum(lo - x_r, x_r - hi), 0.0)
    dy = torch.clamp_min(torch.maximum(ylo - y_r, y_r - (ylo + tile)), 0.0)
    return include & (dx * dx + dy * dy <= r2), g


def stereo_lists(left: TileLists, s: Splats, ranks: torch.Tensor, *, tile: int,
                 width: int, n_cat: int) -> TileLists:
    """Right-eye tile lists by shift-merging the left (widened) lists,
    written as the reference writes it: one stable sort per tile, then a
    duplicate drop and a compaction."""
    tiles_x_r = -(-width // tile)
    l_len = left.lists.shape[1]
    src = _source_rows(left, tiles_x_r, n_cat)
    cand = src.reshape(src.shape[0], n_cat * l_len)
    include, g = _include(cand, s, tiles_x_r, tile)

    rank_key = torch.where(include, ranks[g].long(), torch.full_like(g, _I32_MAX))
    order = torch.argsort(rank_key, dim=1, stable=True)
    sorted_g = torch.gather(g, 1, order)
    sorted_inc = torch.gather(include, 1, order)
    sorted_rank = torch.gather(rank_key, 1, order)
    dup = torch.zeros_like(sorted_inc)
    dup[:, 1:] = sorted_rank[:, 1:] == sorted_rank[:, :-1]
    keep = sorted_inc & ~dup

    pos = torch.arange(n_cat * l_len, device=g.device)[None, :].expand_as(g)
    comp_key = torch.where(keep, pos, torch.full_like(pos, _I32_MAX))
    comp_order = torch.argsort(comp_key, dim=1, stable=True)
    comp_g = torch.gather(sorted_g, 1, comp_order)
    comp_keep = torch.gather(keep, 1, comp_order)
    out = torch.where(comp_keep, comp_g, torch.full_like(comp_g, -1))[:, :l_len]
    counts = comp_keep.sum(1)
    overflow = left.overflow | (counts > l_len).any()
    return TileLists(lists=out.to(torch.int32),
                     counts=torch.clamp_max(counts, l_len).to(torch.int32),
                     overflow=overflow, tiles_x=tiles_x_r, tiles_y=left.tiles_y)


def build_merge_sources(left: TileLists, s: Splats, ranks: torch.Tensor, *,
                        tile: int, width: int, n_cat: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SRU front end: per right tile, the n_cat include-filtered, compacted,
    depth-sorted source rows (what the line buffer holds). Returns
    (ranks, ids), both (n_tiles_r, n_cat, L) int32, INF_RANK / -1 padded."""
    tiles_x_r = -(-width // tile)
    src = _source_rows(left, tiles_x_r, n_cat)
    include, g = _include(src, s, tiles_x_r, tile)
    ranks_src = torch.where(include, ranks[g], torch.full_like(src, INF_RANK))
    ids_src = torch.where(include, g.to(torch.int32), torch.full_like(src, -1))
    # compact each row (entries are sorted; excluded → INF sinks to the end)
    order = torch.argsort(ranks_src, dim=-1, stable=True)
    return (torch.gather(ranks_src, -1, order).contiguous(),
            torch.gather(ids_src, -1, order).contiguous())


def stereo_merge(left: TileLists, s: Splats, ranks: torch.Tensor, *, tile: int,
                 width: int, n_cat: int) -> TileLists:
    """Right-eye lists through the merge front end and K4 (same TileLists
    as `stereo_lists`)."""
    src_ranks, src_ids = build_merge_sources(left, s, ranks, tile=tile,
                                             width=width, n_cat=n_cat)
    l_len = left.lists.shape[1]
    out, counts, ovf = stereo_merge_kernel(src_ranks, src_ids)
    return TileLists(lists=out, counts=torch.clamp_max(counts, l_len),
                     overflow=left.overflow | ovf.any(),
                     tiles_x=-(-width // tile), tiles_y=left.tiles_y)


@dataclasses.dataclass(frozen=True)
class StereoStats:
    """Work-sharing accounting for the client (feeds Figs. 18/21/22)."""

    shared_preprocess: int      # splats projected once instead of twice
    left_blends: int            # (tile, entry) pairs blended for the left eye
    right_candidates: int       # entries merged for the right eye
    right_alpha_skipped: int    # right candidates that failed every left α-check


def alpha_skip_stats(left: TileLists, right: TileLists, left_hits: torch.Tensor,
                     s: Splats) -> StereoStats:
    """How much right-eye work the α-check forwarding removes (paper step ②)."""
    m = s.m
    hit_any = torch.zeros((m + 1,), dtype=torch.bool, device=left.lists.device)
    g = torch.where(left.lists >= 0, left.lists, m).long().reshape(-1)
    hit_any[g[left_hits.reshape(-1)]] = True
    r_valid = right.lists >= 0
    rg = torch.where(r_valid, right.lists, m).long()
    r_hit = hit_any[rg] & r_valid
    return StereoStats(
        shared_preprocess=int(s.visible.sum()),
        left_blends=int((left.lists >= 0).sum()),
        right_candidates=int(r_valid.sum()),
        right_alpha_skipped=int((r_valid & ~r_hit).sum()),
    )
