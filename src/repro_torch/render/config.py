"""Static render-geometry configuration for the client stereo pipeline
(port of `repro.render.config`): tile size, per-eye resolution, list/pair
budgets, the stereo line-buffer width n_cat and the α thresholds."""

from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.core.binning import BinConfig
from repro_torch.core.camera import Camera, StereoRig
from repro_torch.core.projection import ALPHA_MAX, ALPHA_MIN
from repro_torch.core.stereo import n_categories


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static stereo-render geometry.

    width/height: per-eye output resolution in pixels
    tile:         tile side in pixels
    list_len:     per-tile depth-list capacity
    max_pairs:    (splat, tile) expansion budget for binning
    n_cat:        stereo line-buffer rows = ⌊max_disparity/tile⌋ + 2
    alpha_min/alpha_max: α thresholds
    eps_t:        early-termination transmittance of the pooled fleet render
                  (the session's and the vmapped render have no early stop,
                  as the reference's default path)
    """

    width: int
    height: int
    tile: int = 16
    list_len: int = 256
    max_pairs: int = 1 << 16
    n_cat: int = 2
    alpha_min: float = ALPHA_MIN
    alpha_max: float = ALPHA_MAX
    eps_t: float = 0.0

    @classmethod
    def for_rig(cls, rig: StereoRig, *, tile: int = 16, list_len: int = 256,
                max_pairs: int = 1 << 16, eps_t: float = 0.0) -> "RenderConfig":
        """Config for one rig (n_cat from its near-plane disparity bound)."""
        return cls(width=rig.left.width, height=rig.left.height, tile=tile,
                   list_len=list_len, max_pairs=max_pairs,
                   n_cat=n_categories(rig.max_disparity_px(), tile), eps_t=eps_t)

    @classmethod
    def for_fleet(cls, rigs: Iterable[StereoRig], *, tile: int = 16, list_len: int = 256,
                  max_pairs: int = 1 << 16, eps_t: float = 0.0) -> "RenderConfig":
        """Config covering a fleet of rigs: one shared resolution; n_cat is
        the largest over the rigs, so the widened plane covers every
        client's disparity range."""
        rigs = list(rigs)
        if not rigs:
            raise ValueError("for_fleet needs at least one rig")
        w, h = rigs[0].left.width, rigs[0].left.height
        for r in rigs[1:]:
            if (r.left.width, r.left.height) != (w, h):
                raise ValueError("fleet rigs must share one resolution: "
                                 f"{(w, h)} vs {(r.left.width, r.left.height)}")
        n_cat = max(n_categories(r.max_disparity_px(), tile) for r in rigs)
        return cls(width=w, height=h, tile=tile, list_len=list_len,
                   max_pairs=max_pairs, n_cat=n_cat, eps_t=eps_t)

    @property
    def tiles_x(self) -> int:
        """Right-eye (output) tile columns."""
        return -(-self.width // self.tile)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile)

    @property
    def tiles_x_wide(self) -> int:
        """Widened-left tile columns (covers the union of both frusta)."""
        return self.tiles_x + self.n_cat - 1

    @property
    def wide_width(self) -> int:
        return self.tiles_x_wide * self.tile

    def bin_config(self) -> BinConfig:
        return BinConfig(tile=self.tile, max_pairs=self.max_pairs,
                         list_len=self.list_len)

    def widened(self, cam: Camera) -> Camera:
        """The shared-preprocessing camera: same intrinsics and principal
        point, image plane extended to wide_width columns."""
        return dataclasses.replace(cam, width=self.wide_width)
