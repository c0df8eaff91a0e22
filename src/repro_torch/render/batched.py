"""Fleet-batched stereo rendering: B clients' queues in one call. Port of
`repro.render.batched`.

Two paths, the same math:

  * `path="vmap"` — each client's project → bin → merge → rasterize chain
    in turn, per client exactly the single-client `render_stereo` (K2 once
    per eye and client on the card).
  * `path="pooled"` — plans are built per client, then the occupied
    (client, eye, tile) slabs of the whole fleet are pooled, repeat-padded
    to a pow2 bucket, and rasterized by ONE K2 launch with per-tile pixel
    origins. Empty tiles and inactive slots never reach the kernel. Tiles
    are independent, so at eps_t = 0 the images are bit for bit the vmap
    path's. As the reference's pooled path, the launch keeps the Pallas
    contract: it stops a tile once max T ≤ `cfg.eps_t` and flags no left
    entry after the stop, so `right_alpha_skipped` can be larger than the
    vmap path's where a tile saturates. Unlike the reference's pooled path,
    it honours `cfg`'s α thresholds.

Rigs are batched like the reference's pytrees (`stack_rigs`): the static
fields (resolution, near/far, baseline) must agree; pose and focal are
leaves with a leading client axis.

Under a serving mesh each client shard renders its own slots (the queues
and rigs it passes are its block) and holds their frames; the pooled K2
launch over one shard's tiles gives the pixels of the fleet-wide pool,
since tiles are independent.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch import pytree
from repro_torch.core import lod_search as ls
from repro_torch.core.camera import StereoRig
from repro_torch.core.gaussians import Gaussians
from repro_torch.kernels import rasterize as kraster
from repro_torch.render.config import RenderConfig
from repro_torch.render.plan import StereoFrameStats, frame_stats
from repro_torch.render.stages import build_plan, render_stereo


def stack_rigs(rigs: Sequence[StereoRig]) -> StereoRig:
    """Stack rigs on a leading client axis. Static fields must agree."""
    rigs = list(rigs)

    def key(r):
        c = r.left
        return (c.width, c.height, c.near, c.far, c.cx, c.cy, r.baseline)

    for r in rigs[1:]:
        if key(r) != key(rigs[0]):
            raise ValueError(f"rig static fields differ: {key(rigs[0])} vs {key(r)}")
    return pytree.stack(rigs)


def batched_build_plans(queues: Gaussians, rigs: StereoRig, cfg: RenderConfig):
    """Every client's RenderPlan, as a list in slot order."""
    return [build_plan(pytree.take(queues, b), pytree.take(rigs, b), cfg)
            for b in range(queues.mu.shape[0])]


def _single_frame(queue, rig, cfg):
    plan = build_plan(queue, rig, cfg)
    img_l, img_r, hits = render_stereo(plan, cfg)
    return img_l, img_r, frame_stats(plan, hits)


def batched_render_stereo(queues: Gaussians, rigs: StereoRig, cfg: RenderConfig, *,
                          path: str = "vmap", active=None
                          ) -> Tuple[torch.Tensor, torch.Tensor, StereoFrameStats]:
    """Render B clients → (img_l (B,H,W,3), img_r (B,H,W,3), per-client
    StereoFrameStats with (B,) leaves). `queues`/`rigs` lead with the client
    axis. `active` (B,) bool: on the pooled path an inactive slot's tiles
    never reach the kernel and its frames are black (the vmap path renders
    every slot; an inactive slot's queue is empty anyway)."""
    if path == "vmap":
        out = [_single_frame(pytree.take(queues, b), pytree.take(rigs, b), cfg)
               for b in range(queues.mu.shape[0])]
        img_l, img_r, stats = zip(*out)
        return torch.stack(img_l), torch.stack(img_r), pytree.stack(stats)
    if path == "pooled":
        return _pooled_render(queues, rigs, cfg, active=active)
    raise ValueError(f"unknown batched render path: {path!r}")


# ---------------------------------------------------------------------------
# pooled path: occupied tiles of the whole fleet, one K2 launch
# ---------------------------------------------------------------------------


def _gather_fleet_slabs(plans, cfg: RenderConfig):
    """(entries, counts, origins) for every (client, eye, tile) slab: the
    left slabs of every client (on the widened grid — all of them are
    rasterized, since even cropped columns feed the α-hit forwarding), then
    the right slabs. Origins are pixel-space tile corners."""
    ents, cnts, orgs = [], [], []
    for eye in ("left", "right"):
        tiles_x = cfg.tiles_x_wide if eye == "left" else cfg.tiles_x
        for plan in plans:
            lists = plan.left if eye == "left" else plan.right
            ent, cnt = kraster.gather_entries(lists, plan.splats, eye)
            ents.append(ent)
            cnts.append(cnt)
            orgs.append(kraster.tile_origins(cnt.shape[0], tiles_x, cfg.tile, cnt.device))
    return torch.cat(ents), torch.cat(cnts).contiguous(), torch.cat(orgs)


def _scatter_slabs(sel, tiles_img, hits, *, n_slabs: int, tile: int, l_len: int):
    """Pooled kernel outputs back into the dense fleet slab array.
    Repeat-padded slabs write identical values."""
    imgs = torch.zeros((n_slabs, tile, tile, 3), dtype=torch.float32, device=sel.device)
    flags = torch.zeros((n_slabs, l_len), dtype=torch.bool, device=sel.device)
    return imgs.index_put((sel,), tiles_img), flags.index_put((sel,), hits)


def _assemble(tiles_img, tiles_y, tiles_x, tile, height, width):
    img = tiles_img.reshape(-1, tiles_y, tiles_x, tile, tile, 3)
    img = img.permute(0, 1, 3, 2, 4, 5).reshape(-1, tiles_y * tile, tiles_x * tile, 3)
    return img[:, :height, :width]


def _pooled_render(queues, rigs, cfg: RenderConfig, *, active=None):
    plans = batched_build_plans(queues, rigs, cfg)
    b = len(plans)
    entries, counts, origins = _gather_fleet_slabs(plans, cfg)
    n_l = b * cfg.tiles_x_wide * cfg.tiles_y
    n_slabs = counts.shape[0]
    occ = counts > 0
    if active is not None:
        act = torch.as_tensor(active, dtype=torch.bool, device=occ.device)
        occ = occ & torch.cat([act.repeat_interleave(cfg.tiles_x_wide * cfg.tiles_y),
                               act.repeat_interleave(cfg.tiles_x * cfg.tiles_y)])
    occupied = torch.nonzero(occ, as_tuple=True)[0]
    n_occ = int(occupied.numel())
    if n_occ:
        bucket = ls.pow2_bucket(n_occ, n_slabs)
        sel = occupied[torch.arange(bucket, device=occupied.device) % n_occ]
        tiles_img, hits = kraster.rasterize_slabs(entries[sel], counts[sel], origins[sel],
                                                  tile=cfg.tile, eps_t=cfg.eps_t,
                                                  alpha_min=cfg.alpha_min,
                                                  alpha_max=cfg.alpha_max)
        all_img, all_hits = _scatter_slabs(sel, tiles_img, hits, n_slabs=n_slabs,
                                           tile=cfg.tile, l_len=cfg.list_len)
    else:
        all_img = torch.zeros((n_slabs, cfg.tile, cfg.tile, 3), dtype=torch.float32,
                              device=counts.device)
        all_hits = torch.zeros((n_slabs, cfg.list_len), dtype=torch.bool,
                               device=counts.device)
    img_l = _assemble(all_img[:n_l], cfg.tiles_y, cfg.tiles_x_wide, cfg.tile,
                      cfg.height, cfg.width)
    img_r = _assemble(all_img[n_l:], cfg.tiles_y, cfg.tiles_x, cfg.tile,
                      cfg.height, cfg.width)
    left_hits = all_hits[:n_l].reshape(b, -1, cfg.list_len)
    stats = pytree.stack([frame_stats(plan, left_hits[i]) for i, plan in enumerate(plans)])
    return img_l, img_r, stats
