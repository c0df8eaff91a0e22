"""K2 — tile rasterization (the paper's VRC, §5) on Hopper.

`rasterize_slabs` launches `csrc/rasterize.cu` (one thread block per tile,
2 or 4 pixels of a row per thread, entries staged and voted on a window at
a time) for CUDA tensors and runs `rasterize_slabs_plain` for CPU tensors.
Input is the pre-gathered entry layout of the reference's Pallas kernel: entries[t, i] = [mean_x, mean_y, conic_a, conic_b, conic_c,
r, g, b, opacity] (invalid slots carry opacity 0), a count per tile and a
pixel-space origin per tile. Blending is front to back with the α test of
`repro_torch.render.common.splat_alpha` under the given α thresholds. A
tile stops once no pixel has transmittance above `eps_t` (0.0 stops only
where every T is 0, which changes no color); with eps_t ≥ 1 it blends
nothing, as the reference's Pallas kernel, whose while-loop tests the
transmittance before the first entry. A stop is exact only while T cannot
increase, so under thresholds that let α leave [0, 1] (`stop_allowed`)
there is none and `eps_t` is ignored. The per-entry hit flag (α > 0 at
some pixel) is what the SRU forwards to the right eye: with
`hits_past_stop=False` (the reference's Pallas contract) the entries after
a stop get 0, with `hits_past_stop=True` (its default path, which has no
stop) every entry up to the count gets its flag.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.binning import TileLists
from repro_torch.core.projection import ALPHA_MAX, ALPHA_MIN, Splats
from repro_torch.kernels import _build
from repro_torch.render.common import entry_alpha, eye_views

ENTRY_COLS = 9


def gather_entries(lists: TileLists, s: Splats, eye: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-gather per-tile entry rows (the Fig. 14 attribute broadcast):
    (n_tiles, L, 9) float32 and the (n_tiles,) counts."""
    means, colors = eye_views(s, eye)
    idx = lists.lists
    g = idx.clamp(0, max(s.m - 1, 0)).long()
    valid = idx >= 0
    opa = torch.where(valid, s.opacity[g], torch.zeros((), device=idx.device))
    ent = torch.cat([means[g], s.conic[g], colors[g], opa[..., None]], -1)
    return ent.to(torch.float32).contiguous(), lists.counts


def tile_origins(n_tiles: int, tiles_x: int, tile: int, device) -> torch.Tensor:
    """(n_tiles, 2) int32 pixel corners of a row-major tile grid."""
    idx = torch.arange(n_tiles, dtype=torch.int32, device=device)
    return torch.stack([(idx % tiles_x) * tile, (idx // tiles_x) * tile], -1).contiguous()


def stop_allowed(alpha_min: float, alpha_max: float) -> bool:
    """Whether a tile may stop early: T never increases iff every α after
    the thresholds lies in [0, 1], which holds when 0 < alpha_min and
    alpha_max ≤ 1."""
    return 0.0 < alpha_min and alpha_max <= 1.0


def rasterize_slabs_plain(entries: torch.Tensor, counts: torch.Tensor,
                          origins: torch.Tensor, *, tile: int, eps_t: float = 0.0,
                          alpha_min: float = ALPHA_MIN, alpha_max: float = ALPHA_MAX,
                          hits_past_stop: bool = False, with_processed: bool = False):
    """The plain version of K2 (the reference's `ref_rasterize_slabs`),
    batched over tiles. Returns (tiles (n, T, T, 3), hits (n, L)), and with
    `with_processed` also the (n,) number of entries each tile blended
    before it stopped (the work the kernel does, entry by entry)."""
    n, l_max, _ = entries.shape
    dev = entries.device
    ar = torch.arange(tile, device=dev, dtype=torch.float32)
    px = ar[None, None, :] + origins[:, 0].to(torch.float32)[:, None, None] + 0.5
    py = ar[None, :, None] + origins[:, 1].to(torch.float32)[:, None, None] + 0.5
    px, py = px.expand(n, tile, tile), py.expand(n, tile, tile)
    color = torch.zeros((n, tile, tile, 3), dtype=torch.float32, device=dev)
    t_acc = torch.ones((n, tile, tile), dtype=torch.float32, device=dev)
    hits = torch.zeros((n, l_max), dtype=torch.bool, device=dev)
    can_stop = stop_allowed(alpha_min, alpha_max)
    # the tile is tested before its first entry too (T = 1 there)
    alive = torch.full((n,), 1.0 > eps_t or not can_stop, dtype=torch.bool, device=dev)
    processed = torch.zeros((n,), dtype=torch.int32, device=dev)
    zero = torch.zeros((), device=dev)
    # entries past the largest count are inactive everywhere: they add 0 to
    # the color and multiply T by 1, so the loop may stop there
    steps = min(l_max, int(counts.max())) if n > 0 else 0
    for i in range(steps):
        e = entries[:, i, :]
        a_raw = entry_alpha(px, py, e[:, None, None, :], alpha_min=alpha_min,
                            alpha_max=alpha_max)
        in_count = i < counts
        active = alive & in_count
        a = torch.where(active[:, None, None], a_raw, zero)
        contrib = t_acc * a
        color = color + contrib[..., None] * e[:, None, None, 5:8]
        t_acc = t_acc * (1.0 - a)
        flagged = in_count if hits_past_stop else active
        hits[:, i] = flagged & (a_raw > 0.0).flatten(1).any(1)
        processed += active.to(torch.int32)
        if can_stop:
            alive = alive & (t_acc.flatten(1).amax(1) > eps_t)
    return (color, hits, processed) if with_processed else (color, hits)


def _kernel_thresholds(alpha_min: float, alpha_max: float):
    """(alpha_min, alpha_max) as K2 takes them: a pair under which no α can
    pass (alpha_max < alpha_min, or a NaN) becomes alpha_min = NaN."""
    amin, amax = float(alpha_min), float(alpha_max)
    return (amin if amax >= amin else math.nan), amax


def rasterize_slabs(entries: torch.Tensor, counts: torch.Tensor, origins: torch.Tensor,
                    *, tile: int, eps_t: float = 0.0, alpha_min: float = ALPHA_MIN,
                    alpha_max: float = ALPHA_MAX, hits_past_stop: bool = False):
    """Rasterize tiles, each with its own pixel origin: (tiles (n,T,T,3),
    hits (n,L)). CPU tensors run the plain version; CUDA tensors launch K2."""
    dev = entries.device
    if dev.type == "cpu":
        return rasterize_slabs_plain(entries, counts, origins, tile=tile, eps_t=eps_t,
                                     alpha_min=alpha_min, alpha_max=alpha_max,
                                     hits_past_stop=hits_past_stop)
    if dev.type != "cuda":
        raise ValueError(f"rasterize_slabs: unsupported device {dev}")
    n, l_max, cols = entries.shape
    if cols != ENTRY_COLS or entries.dtype != torch.float32:
        raise ValueError(f"rasterize_slabs: entries must be float32 (n, L, 9), got "
                         f"{entries.dtype} {tuple(entries.shape)}")
    for name, t, shape in (("counts", counts, (n,)), ("origins", origins, (n, 2))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"rasterize_slabs: {name} must be int32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    for name, t in (("entries", entries), ("counts", counts), ("origins", origins)):
        if not t.is_contiguous():
            raise ValueError(f"rasterize_slabs: {name} must be contiguous")
    if tile * tile > 1024 or (tile * tile) % 32:
        raise ValueError(f"rasterize_slabs: tile {tile} has {tile * tile} pixels; the "
                         "kernel takes a multiple of 32 up to 1024")
    out = torch.empty((n, tile, tile, 3), dtype=torch.float32, device=dev)
    hits = torch.empty((n, l_max), dtype=torch.bool, device=dev)
    if n > 0:
        lib = _build.library()
        p = _build.ptr
        amin, amax = _kernel_thresholds(alpha_min, alpha_max)
        err = lib.nebula_rasterize_slabs(p(entries), p(counts), p(origins), p(out),
                                         p(hits), n, l_max, tile, float(eps_t), amin, amax,
                                         int(stop_allowed(alpha_min, alpha_max)),
                                         int(hits_past_stop), _build.stream_handle(dev))
        _build.check(err, "nebula_rasterize_slabs")
        rasterize_slabs.launches += 1
    return out, hits


rasterize_slabs.launches = 0


def rasterize(lists: TileLists, s: Splats, *, width: int, height: int, tile: int,
              eye: str, eps_t: float = 0.0,
              alpha_min: float = ALPHA_MIN, alpha_max: float = ALPHA_MAX,
              hits_past_stop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tile raster of one eye → (image (H, W, 3), α-hit flags (n_tiles, L))."""
    entries, counts = gather_entries(lists, s, eye)
    origins = tile_origins(entries.shape[0], lists.tiles_x, tile, entries.device)
    tiles_img, hits = rasterize_slabs(entries, counts.contiguous(), origins, tile=tile,
                                      eps_t=eps_t, alpha_min=alpha_min,
                                      alpha_max=alpha_max, hits_past_stop=hits_past_stop)
    ty, tx = lists.tiles_y, lists.tiles_x
    img = tiles_img.reshape(ty, tx, tile, tile, 3).permute(0, 2, 1, 3, 4)
    return img.reshape(ty * tile, tx * tile, 3)[:height, :width], hits
