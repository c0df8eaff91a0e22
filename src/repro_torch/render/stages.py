"""Client render stages: project → bin_shared → stereo_merge → rasterize
(paper Fig. 13/§4.4), over a static `RenderConfig`. Port of
`repro.render.stages`.

On the card each stage that the reference could hand to a Pallas kernel
runs a hand-written kernel: projection (K3), the shift-merge (K4) and the
raster of both eyes (K2); binning, sorts in the reference, runs the chain
of `kernels/binning.py`. `render_tiles` and `render_reference` are the
plain rasterizers, kept for checks.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import tracing
from repro_torch.core import projection as proj
from repro_torch.core import stereo
from repro_torch.core.binning import TileLists, bin_left
from repro_torch.core.camera import StereoRig
from repro_torch.core.gaussians import Gaussians
from repro_torch.core.projection import ALPHA_MAX, ALPHA_MIN, Splats, depth_ranks
from repro_torch.kernels import rasterize as kraster
from repro_torch.render.common import eye_views, pixel_alpha, splat_alpha
from repro_torch.render.config import RenderConfig
from repro_torch.render.plan import RenderPlan


# ---------------------------------------------------------------------------
# plain rasterizers
# ---------------------------------------------------------------------------


def render_tiles(lists: TileLists, s: Splats, *, width: int, height: int,
                 tile: int, eye: str, alpha_min: float = ALPHA_MIN,
                 alpha_max: float = ALPHA_MAX) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain tiled render from per-tile lists. Returns (image (H,W,3),
    alpha_hit (n_tiles, L)); alpha_hit[t, i] — entry i of tile t passed the
    α test at ≥1 pixel."""
    means, colors = eye_views(s, eye)
    tiles_x, tiles_y = lists.tiles_x, lists.tiles_y
    n_tiles, l_len = lists.lists.shape
    dev = lists.lists.device
    origins = kraster.tile_origins(n_tiles, tiles_x, tile, dev).to(torch.float32)
    ar = torch.arange(tile, device=dev)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    px_local = torch.stack([xx + 0.5, yy + 0.5], -1).to(torch.float32)  # (T, T, 2)
    px = px_local[None] + origins[:, None, None, :]                    # (n, T, T, 2)

    color = torch.zeros((n_tiles, tile, tile, 3), dtype=torch.float32, device=dev)
    t_acc = torch.ones((n_tiles, tile, tile), dtype=torch.float32, device=dev)
    hits = torch.zeros((n_tiles, l_len), dtype=torch.bool, device=dev)
    zero = torch.zeros((), device=dev)
    for i in range(l_len):
        idx = lists.lists[:, i]
        valid = idx >= 0
        g = idx.clamp(0, max(s.m - 1, 0)).long()
        d = px - means[g][:, None, None, :]
        c = s.conic[g]
        a = splat_alpha(d[..., 0], d[..., 1], c[:, 0, None, None], c[:, 1, None, None],
                        c[:, 2, None, None], s.opacity[g][:, None, None],
                        alpha_min=alpha_min, alpha_max=alpha_max)
        a = torch.where(valid[:, None, None], a, zero)
        contrib = t_acc * a
        color = color + contrib[..., None] * colors[g][:, None, None, :]
        t_acc = t_acc * (1.0 - a)
        hits[:, i] = (a > 0.0).flatten(1).any(1)
    img = color.reshape(tiles_y, tiles_x, tile, tile, 3).permute(0, 2, 1, 3, 4)
    return img.reshape(tiles_y * tile, tiles_x * tile, 3)[:height, :width], hits


def render_reference(s: Splats, *, width: int, height: int, eye: str,
                     alpha_min: float = ALPHA_MIN,
                     alpha_max: float = ALPHA_MAX) -> torch.Tensor:
    """Oracle: per-pixel blend of every splat in global depth order (no tiles)."""
    means, colors = eye_views(s, eye)
    key = torch.where(s.visible, s.depth, torch.full_like(s.depth, float("inf")))
    order = torch.argsort(key, stable=True).tolist()
    dev = key.device
    yy, xx = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    px = torch.stack([xx + 0.5, yy + 0.5], -1).to(torch.float32)
    color = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    t_acc = torch.ones((height, width), dtype=torch.float32, device=dev)
    visible = s.visible.tolist()
    for g in order:
        if not visible[g]:  # α = 0: adds 0 to the color, multiplies T by 1
            continue
        a = pixel_alpha(px, means[g], s.conic[g], s.opacity[g],
                        alpha_min=alpha_min, alpha_max=alpha_max)
        contrib = t_acc * a
        color = color + contrib[..., None] * colors[g]
        t_acc = t_acc * (1.0 - a)
    return color


# ---------------------------------------------------------------------------
# pipeline stages
# ---------------------------------------------------------------------------


def project(queue: Gaussians, rig: StereoRig, cfg: RenderConfig
            ) -> Tuple[Splats, torch.Tensor]:
    """Shared stereo preprocessing (K3): one projection on the widened-left
    plane + one depth sort serve both eyes. Returns (splats, ranks)."""
    with tracing.span("project"):
        splats = proj.project(queue, rig, cfg.widened(rig.left))
        return splats, depth_ranks(splats)


def bin_shared(splats: Splats, ranks: torch.Tensor, cfg: RenderConfig) -> TileLists:
    """Depth-ordered tile binning on the widened grid (left eye)."""
    with tracing.span("bin_shared"):
        return bin_left(splats, cfg.wide_width, cfg.height, cfg.bin_config(), ranks)


def stereo_merge(splats: Splats, ranks: torch.Tensor, left: TileLists,
                 cfg: RenderConfig) -> TileLists:
    """Right-eye lists via the SRU front end and the k-way merge (K4)."""
    with tracing.span("stereo_merge"):
        return stereo.stereo_merge(left, splats, ranks, tile=cfg.tile, width=cfg.width,
                                   n_cat=cfg.n_cat)


def build_plan(queue: Gaussians, rig: StereoRig, cfg: RenderConfig) -> RenderPlan:
    """project → bin_shared → stereo_merge, composed."""
    splats, ranks = project(queue, rig, cfg)
    left = bin_shared(splats, ranks, cfg)
    right = stereo_merge(splats, ranks, left, cfg)
    return RenderPlan(splats=splats, ranks=ranks, left=left, right=right)


def rasterize(plan: RenderPlan, cfg: RenderConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rasterize both eyes (K2) → (img_l, img_r, left α-hit flags), with
    the results of the reference's default path (`render_tiles`): its α
    thresholds, no early stop by `cfg.eps_t` (eps_t 0 stops a tile only
    once every T is 0, which changes no color), and a left hit flag for
    every entry up to the count, past a stop too. The right eye's flags
    are not used, so its tiles keep the cheaper contract."""
    kw = dict(width=cfg.width, height=cfg.height, tile=cfg.tile, eps_t=0.0,
              alpha_min=cfg.alpha_min, alpha_max=cfg.alpha_max)
    with tracing.span("rasterize"):
        img_l, hits = kraster.rasterize(plan.left, plan.splats, eye="left",
                                        hits_past_stop=True, **kw)
        img_r, _ = kraster.rasterize(plan.right, plan.splats, eye="right", **kw)
    return img_l, img_r, hits


def render_stereo(plan: RenderPlan, cfg: RenderConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One call from plan to pixels: (img_l, img_r, left α-hit flags)."""
    return rasterize(plan, cfg)


def render_stereo_reference(queue: Gaussians, rig: StereoRig,
                            cfg: RenderConfig = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two fully independent untiled eye renders from the same splats."""
    if cfg is None:
        cfg = RenderConfig.for_rig(rig)
    splats, _ranks = project(queue, rig, cfg)
    kw = dict(width=cfg.width, height=cfg.height, alpha_min=cfg.alpha_min,
              alpha_max=cfg.alpha_max)
    return (render_reference(splats, eye="left", **kw),
            render_reference(splats, eye="right", **kw))
