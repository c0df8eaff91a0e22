"""One eye's image of a render queue, tile by tile (3DGS, paper §2 and §4.4).

The left eye's EWA splats (a 0.3-pixel low-pass, the α ≥ 1/255 ellipse as
each splat's extent, the SH colour seen from the eye). The right eye sits
`baseline` metres along the left camera's x axis; its splats are the left
eye's moved by their disparity baseline·focal/depth, with the same depth
and 2D covariance (Nebula's shared stereo preprocessing of a rectified
pair) and the colour seen from the right eye, binned on the right eye's
own tiles (not by the shift merge). A splat joins a 16×16 tile where its extent's box
covers the tile and the tile's nearest point lies within its α ≥ 1/255
radius. Each tile keeps its nearest `list_len` splats, front to back by
depth (a tie to the lower queue index), and blends them at every pixel
centre: α = min(0.99, opacity · exp(−½ dᵀ Σ⁻¹ d)), 0 below 1/255,
C += T·α·colour, T ·= 1 − α."""

from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
COV_BLUR = 0.3


def _sh_color(sh, dirs):
    k = sh.shape[1]
    c = SH_C0 * sh[:, 0, :]
    if k >= 4:
        x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
        c = c - SH_C1 * y * sh[:, 1, :] + SH_C1 * z * sh[:, 2, :] - SH_C1 * x * sh[:, 3, :]
    if k > 4:
        raise ValueError("the reference renders SH degree 0 or 1")
    return torch.clamp_min(c + 0.5, 0.0)


def project(rows: dict, pos, rot, focal: float, cx: float, cy: float, near: float,
            far: float, width: int, height: int, dtype, baseline: float = 0.0):
    """EWA splats of `rows` for the camera at `pos` with camera-to-world
    rotation `rot`: (mean (M,2), depth, conic (M,3), ext (M,2), colour (M,3),
    opacity, visible). With a `baseline`, the splats of the eye that far
    along the camera's x axis: the same depth and 2D covariance, the mean
    moved by the disparity baseline·focal/depth, the colour seen from there,
    and the visibility tested where they land."""
    mu = rows["mu"].to(dtype)
    rot = rot.to(dtype)
    d = mu - pos.to(dtype)
    t = d @ rot                           # camera coordinates: x right, y down, z ahead
    z = t[:, 2]
    inv_z = 1.0 / torch.clamp_min(z, 1e-6)
    mean = torch.stack([focal * t[:, 0] * inv_z + cx - baseline * focal * inv_z,
                        focal * t[:, 1] * inv_z + cy], 1)
    q = rows["quat"].to(dtype)
    q = q / (torch.sqrt((q * q).sum(1, keepdim=True)) + 1e-12)
    w, x, y, zq = q.unbind(1)
    r = torch.stack([1 - 2 * (y * y + zq * zq), 2 * (x * y - w * zq), 2 * (x * zq + w * y),
                     2 * (x * y + w * zq), 1 - 2 * (x * x + zq * zq), 2 * (y * zq - w * x),
                     2 * (x * zq - w * y), 2 * (y * zq + w * x), 1 - 2 * (x * x + y * y)],
                    1).reshape(-1, 3, 3)
    rs = r * torch.exp(rows["log_scale"].to(dtype))[:, None, :]
    cov3 = rs @ rs.transpose(1, 2)
    zero = torch.zeros_like(z)
    jac = torch.stack([torch.stack([focal * inv_z, zero, -focal * t[:, 0] * inv_z * inv_z], 1),
                       torch.stack([zero, focal * inv_z, -focal * t[:, 1] * inv_z * inv_z], 1)],
                      1)                                           # (M, 2, 3)
    jw = jac @ rot.T
    cov2 = jw @ cov3 @ jw.transpose(1, 2)
    a, b, c = cov2[:, 0, 0] + COV_BLUR, cov2[:, 0, 1], cov2[:, 1, 1] + COV_BLUR
    det = torch.clamp_min(a * c - b * b, 1e-12)
    opa = rows["opacity"].to(dtype)
    tau2 = torch.clamp_min(2.0 * torch.log(torch.clamp_min(opa, ALPHA_MIN) / ALPHA_MIN), 0.0)
    ext = torch.stack([torch.sqrt(tau2 * a), torch.sqrt(tau2 * c)], 1)
    d_eye = mu - (pos + rot[:, 0] * baseline).to(dtype)
    dirs = d_eye / (torch.sqrt((d_eye * d_eye).sum(1, keepdim=True)) + 1e-12)
    color = _sh_color(rows["sh"].to(dtype), dirs)
    visible = ((z > near) & (z < far) & (opa > ALPHA_MIN)
               & (mean[:, 0] + ext[:, 0] >= 0.0) & (mean[:, 0] - ext[:, 0] <= width)
               & (mean[:, 1] + ext[:, 1] >= 0.0) & (mean[:, 1] - ext[:, 1] <= height))
    conic = torch.stack([c / det, -b / det, a / det], 1)
    return mean, z, conic, ext, color, opa, visible


def spans(mean, ext, visible, width: int, height: int, tile: int):
    """Each splat's first tile column and row and its span of tiles
    (x0, y0, w, h): the tiles its extent's box covers, none where it is
    not visible. w·h is its (splat, tile) pairs before the cull."""
    tx_n, ty_n = -(-width // tile), -(-height // tile)
    mf, ef = mean.float(), ext.float()
    edge = [torch.floor((mf[:, i] + s * ef[:, i]) / tile).clamp(-2.0**30, 2.0**30).long()
            .clamp(0, n - 1) for i, n in ((0, tx_n), (1, ty_n)) for s in (-1, 1)]
    x0, x1, y0, y1 = edge
    return (x0, y0, torch.where(visible, x1 - x0 + 1, 0), torch.where(visible, y1 - y0 + 1, 0))


def tile_lists(mean, depth, conic, ext, opa, visible, width: int, height: int,
               tile: int, list_len: int):
    """(lists (n_tiles, list_len) int64, -1 padded; pairs before the cull)."""
    dev = mean.device
    tx_n, ty_n = -(-width // tile), -(-height // tile)
    m = mean.shape[0]
    key = torch.where(visible, depth.float(), torch.full_like(depth.float(), math.inf))
    rank = torch.empty(m, dtype=torch.int64, device=dev)
    rank[torch.sort(key, stable=True)[1]] = torch.arange(m, device=dev)
    x0, y0, w, h = spans(mean, ext, visible, width, height, tile)
    counts = w * h
    total = int(counts.sum())
    gid = torch.repeat_interleave(torch.arange(m, device=dev), counts)
    local = torch.arange(total, device=dev) - (torch.cumsum(counts, 0) - counts)[gid]
    wg = w[gid]
    tx = x0[gid] + local % wg
    ty = y0[gid] + local // wg
    del local, wg
    # the α ≥ 1/255 radius: 2·λ_max·ln(opacity / α_min), λ_max of the 2D covariance
    ca, cb, cc = conic.unbind(1)
    lam_min = (ca + cc) / 2 - torch.sqrt(((ca - cc) / 2) ** 2 + cb * cb)
    r2 = (2.0 / torch.clamp_min(lam_min, 1e-12)
          * torch.log(torch.clamp_min(opa, ALPHA_MIN) / ALPHA_MIN))
    mx, my = mean[gid, 0], mean[gid, 1]
    cx0, cy0 = (tx * tile).to(mean.dtype), (ty * tile).to(mean.dtype)
    dx = torch.clamp_min(torch.maximum(cx0 - mx, mx - (cx0 + tile)), 0.0)
    dy = torch.clamp_min(torch.maximum(cy0 - my, my - (cy0 + tile)), 0.0)
    keep = dx * dx + dy * dy <= r2[gid]
    tile_id = (ty * tx_n + tx)[keep]
    gid = gid[keep]
    order = torch.sort(tile_id * (m + 1) + rank[gid])[1]
    tile_id, gid = tile_id[order], gid[order]
    n_tiles = tx_n * ty_n
    start = torch.searchsorted(tile_id, torch.arange(n_tiles, device=dev))
    pos = torch.arange(tile_id.numel(), device=dev) - start[tile_id]
    inl = pos < list_len
    lists = torch.full((n_tiles, list_len), -1, dtype=torch.int64, device=dev)
    lists[tile_id[inl], pos[inl]] = gid[inl]
    return lists, total


def blend(lists, mean, conic, color, opa, width: int, height: int, tile: int, dtype):
    """(height, width, 3) float32 image of the tile lists."""
    dev = lists.device
    tx_n, ty_n = -(-width // tile), -(-height // tile)
    n = lists.shape[0]
    t = torch.arange(n, device=dev)
    ar = torch.arange(tile, device=dev, dtype=dtype) + 0.5
    px = ((t % tx_n) * tile).to(dtype)[:, None, None] + ar[None, None, :]
    py = ((t // tx_n) * tile).to(dtype)[:, None, None] + ar[None, :, None]
    img = torch.zeros((n, tile, tile, 3), dtype=dtype, device=dev)
    trans = torch.ones((n, tile, tile), dtype=dtype, device=dev)
    mean, conic, color, opa = mean.to(dtype), conic.to(dtype), color.to(dtype), opa.to(dtype)
    for i in range(lists.shape[1]):
        g = lists[:, i]
        if not bool((g >= 0).any()):
            break
        valid = g >= 0
        g = g.clamp_min(0)
        dx = px - mean[g, 0][:, None, None]
        dy = py - mean[g, 1][:, None, None]
        c = conic[g]
        power = 0.5 * (c[:, 0, None, None] * dx * dx + 2.0 * c[:, 1, None, None] * dx * dy
                       + c[:, 2, None, None] * dy * dy)
        a = torch.clamp_max(opa[g][:, None, None] * torch.exp(-power), ALPHA_MAX)
        a = torch.where((a >= ALPHA_MIN) & valid[:, None, None], a, 0.0)
        img = img + (trans * a)[..., None] * color[g][:, None, None, :]
        trans = trans * (1.0 - a)
    out = img.reshape(ty_n, tx_n, tile, tile, 3).permute(0, 2, 1, 3, 4)
    return out.reshape(ty_n * tile, tx_n * tile, 3)[:height, :width].float()


def render_eye(rows: dict, pos, rot, rig: dict, tile: int, list_len: int, dtype,
               baseline: float = 0.0):
    """(image, pairs): one eye of a render queue `rows`, the camera at
    `pos` (the rig's focal, principal point, near and far planes), or the
    eye `baseline` along its x axis."""
    w, h = rig["width"], rig["height"]
    mean, depth, conic, ext, color, opa, visible = project(
        rows, pos, rot, rig["focal"], w / 2.0, h / 2.0, rig["near"], rig["far"], w, h, dtype,
        baseline)
    lists, pairs = tile_lists(mean, depth, conic, ext, opa, visible, w, h, tile, list_len)
    return blend(lists, mean, conic, color, opa, w, h, tile, dtype), pairs
