"""Depth-ordered tile binning (shared between eyes up to the disparity shift).

Port of `repro.core.binning`. Produces per-tile fixed-length index lists,
front-to-back, from a fixed (splat, tile) pair budget. The reference does
this with sorts and no TPU kernel. `bin_tiles_plain` follows it in plain
tensor ops over the whole budget: two stable argsorts and a right-sided
searchsorted. On the card `bin_tiles` runs the kernel chain of
`kernels/binning.py` instead, whose work scales with the pairs the frame
has, for the same lists.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import tracing
from repro_torch.core.projection import ALPHA_MIN, Splats
from repro_torch.kernels.binning import bin_tiles_kernel
from repro_torch.numerics import div_rn, sqrt_rn

_INT_LIMIT = float(2**30)


@dataclasses.dataclass(frozen=True)
class BinConfig:
    tile: int = 16           # tile side in pixels
    max_pairs: int = 1 << 16  # (gaussian, tile) pair budget
    list_len: int = 256       # per-tile list capacity
    precise_cull: bool = True  # drop pairs beyond the conservative corner circle


@dataclasses.dataclass(frozen=True)
class TileLists:
    """lists[t, i] = splat index (−1 padded), front-to-back within each tile."""

    lists: torch.Tensor       # (n_tiles, list_len) int32
    counts: torch.Tensor      # (n_tiles,) int32
    overflow: torch.Tensor    # () bool — any budget exceeded
    tiles_x: int
    tiles_y: int


def corner_r2(conic: torch.Tensor, opacity: torch.Tensor) -> torch.Tensor:
    """Conservative cull radius²: 2·λ_max·ln(opa/α_min), λ_max of the 2D
    covariance = 1/λ_min of the conic."""
    a_, b_, c_ = conic[:, 0], conic[:, 1], conic[:, 2]
    lam_min_conic = (a_ + c_) / 2 - sqrt_rn(((a_ - c_) / 2) ** 2 + b_ ** 2)
    lam_max = 1.0 / torch.clamp_min(lam_min_conic, 1e-12)
    return 2.0 * lam_max * torch.log(div_rn(torch.clamp_min(opacity, ALPHA_MIN), ALPHA_MIN))


def _floor_div_tile(v: torch.Tensor, tile: int) -> torch.Tensor:
    return torch.floor(div_rn(v, float(tile))).clamp(-_INT_LIMIT, _INT_LIMIT).to(torch.int32)


def tile_span(mean2d, ext, tile: int, tiles_x: int, tiles_y: int):
    """Inclusive tile index ranges covered by each splat's α-AABB."""
    x0 = _floor_div_tile(mean2d[:, 0] - ext[:, 0], tile).clamp(0, tiles_x - 1)
    x1 = _floor_div_tile(mean2d[:, 0] + ext[:, 0], tile).clamp(0, tiles_x - 1)
    y0 = _floor_div_tile(mean2d[:, 1] - ext[:, 1], tile).clamp(0, tiles_y - 1)
    y1 = _floor_div_tile(mean2d[:, 1] + ext[:, 1], tile).clamp(0, tiles_y - 1)
    return x0, x1, y0, y1


def pair_spans(mean2d: torch.Tensor, ext: torch.Tensor, visible: torch.Tensor,
               width: int, height: int, tile: int):
    """Each splat's tile span on a width×height grid, empty where it is culled:
    (x0, y0, span_w, span_h). span_w·span_h is its (splat, tile) pair count
    before the precise cull, which is what the pair budget must hold."""
    tiles_x = -(-width // tile)
    tiles_y = -(-height // tile)
    vis = (visible
           & (mean2d[:, 0] + ext[:, 0] >= 0.0)
           & (mean2d[:, 0] - ext[:, 0] <= width)
           & (mean2d[:, 1] + ext[:, 1] >= 0.0)
           & (mean2d[:, 1] - ext[:, 1] <= height))
    x0, x1, y0, y1 = tile_span(mean2d, ext, tile, tiles_x, tiles_y)
    zero = torch.zeros_like(x0)
    span_w = torch.where(vis, x1 - x0 + 1, zero).long()
    span_h = torch.where(vis, y1 - y0 + 1, zero).long()
    return x0, y0, span_w, span_h


def bin_tiles(mean2d: torch.Tensor, ext: torch.Tensor, ranks: torch.Tensor,
              visible: torch.Tensor, width: int, height: int, cfg: BinConfig,
              conic: torch.Tensor = None, opacity: torch.Tensor = None) -> TileLists:
    """Bin splats into per-tile depth-ordered lists (static budgets). CPU
    tensors run `bin_tiles_plain`; CUDA tensors the kernel chain, which
    gives the same lists, counts and overflow flag."""
    if mean2d.device.type == "cpu":
        return bin_tiles_plain(mean2d, ext, ranks, visible, width, height, cfg,
                               conic=conic, opacity=opacity)
    cull = cfg.precise_cull and conic is not None and opacity is not None
    lists, counts, overflow = bin_tiles_kernel(
        mean2d.contiguous(), ext.contiguous(), ranks, visible,
        corner_r2(conic, opacity) if cull else None, width=width, height=height,
        tile=cfg.tile, max_pairs=cfg.max_pairs, list_len=cfg.list_len)
    return TileLists(lists=lists, counts=counts, overflow=overflow,
                     tiles_x=-(-width // cfg.tile), tiles_y=-(-height // cfg.tile))


def bin_tiles_plain(mean2d: torch.Tensor, ext: torch.Tensor, ranks: torch.Tensor,
                    visible: torch.Tensor, width: int, height: int, cfg: BinConfig,
                    conic: torch.Tensor = None, opacity: torch.Tensor = None) -> TileLists:
    """`bin_tiles` in plain tensor ops over the whole pair budget."""
    dev = mean2d.device
    tile = cfg.tile
    tiles_x = -(-width // tile)
    tiles_y = -(-height // tile)
    n_tiles = tiles_x * tiles_y
    m = mean2d.shape[0]
    if m == 0:   # no splat to gather from: every list empty
        return TileLists(lists=torch.full((n_tiles, cfg.list_len), -1, dtype=torch.int32,
                                          device=dev),
                         counts=torch.zeros((n_tiles,), dtype=torch.int32, device=dev),
                         overflow=torch.zeros((), dtype=torch.bool, device=dev),
                         tiles_x=tiles_x, tiles_y=tiles_y)

    with tracing.span("bin.expand"):
        x0, y0, span_w, span_h = pair_spans(mean2d, ext, visible, width, height, tile)
        counts = span_w * span_h

        offsets = torch.cumsum(counts, 0)
        total = offsets[-1] if m > 0 else torch.zeros((), dtype=torch.long, device=dev)
        starts = offsets - counts
        tracing.count("bin.pairs_needed", total)
        tracing.count("bin.pair_budget", cfg.max_pairs)
        tracing.count("bin.pairs_sorted", cfg.max_pairs)

        p = torch.arange(cfg.max_pairs, dtype=torch.long, device=dev)
        gid = torch.searchsorted(offsets, p, right=True)
        gid_c = gid.clamp(0, max(m - 1, 0))
        local = p - starts[gid_c]
        w_g = torch.clamp_min(span_w[gid_c], 1)
        tx = x0[gid_c].long() + local % w_g
        ty = y0[gid_c].long() + local // w_g
        pair_valid = (p < total) & (gid < m)

        if cfg.precise_cull and conic is not None and opacity is not None:
            r2 = corner_r2(conic, opacity)
            mx = mean2d[gid_c, 0]
            my = mean2d[gid_c, 1]
            cx0 = (tx * tile).to(torch.float32)
            cy0 = (ty * tile).to(torch.float32)
            dx = torch.clamp_min(torch.maximum(cx0 - mx, mx - (cx0 + tile)), 0.0)
            dy = torch.clamp_min(torch.maximum(cy0 - my, my - (cy0 + tile)), 0.0)
            pair_valid = pair_valid & (dx * dx + dy * dy <= r2[gid_c])

        tile_id = torch.where(pair_valid, ty * tiles_x + tx,
                              torch.full_like(tx, n_tiles))  # n_tiles = trash
        rank_key = torch.where(pair_valid, ranks[gid_c].long(), torch.full_like(tx, m))

    with tracing.span("bin.sort"):
        # sort pairs by (tile, depth-rank) via two stable passes
        order1 = torch.argsort(rank_key, stable=True)
        order = order1[torch.argsort(tile_id[order1], stable=True)]
        s_tile = tile_id[order]
        s_gid = gid_c[order]
        s_valid = pair_valid[order]

    with tracing.span("bin.lists"):
        tile_start = torch.searchsorted(
            s_tile, torch.arange(n_tiles + 1, dtype=torch.long, device=dev))
        pos = p - tile_start[s_tile.clamp(0, n_tiles)]
        in_list = s_valid & (pos < cfg.list_len)

        flat = torch.where(in_list, s_tile * cfg.list_len + pos,
                           torch.full_like(pos, n_tiles * cfg.list_len))
        lists = torch.full((n_tiles * cfg.list_len + 1,), -1, dtype=torch.int32, device=dev)
        lists[flat[in_list]] = s_gid[in_list].to(torch.int32)
        lists = lists[:-1].reshape(n_tiles, cfg.list_len)

        per_tile = tile_start[1:] - tile_start[:-1]
        tile_counts = torch.clamp_max(per_tile, cfg.list_len).to(torch.int32)
        overflow = (total > cfg.max_pairs) | (per_tile > cfg.list_len).any()
    return TileLists(lists=lists, counts=tile_counts, overflow=overflow,
                     tiles_x=tiles_x, tiles_y=tiles_y)


def bin_left(s: Splats, wide_width: int, height: int, cfg: BinConfig,
             ranks: torch.Tensor) -> TileLists:
    return bin_tiles(s.mean2d, s.ext, ranks, s.visible, wide_width, height,
                     cfg, conic=s.conic, opacity=s.opacity)


def bin_right(s: Splats, width: int, height: int, cfg: BinConfig,
              ranks: torch.Tensor) -> TileLists:
    shifted = s.mean2d - torch.stack([s.disparity, torch.zeros_like(s.disparity)], -1)
    return bin_tiles(shifted, s.ext, ranks, s.visible, width, height, cfg,
                     conic=s.conic, opacity=s.opacity)
