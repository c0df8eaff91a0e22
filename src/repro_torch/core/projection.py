"""Shared stereo preprocessing: EWA splat projection (paper Fig. 13 left).

Port of `repro.core.projection`. One pass over the render queue serves both
eyes: projection happens on the widened left camera (it covers the union of
the two frusta); the right-eye center is x_R = x_L − B·f/z. Depth is the
same for both eyes of a rectified pair, so one depth sort serves both.
`project` runs kernel K3 (`repro_torch.kernels.preprocess`) on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.camera import Camera, StereoRig
from repro_torch.core.gaussians import Gaussians

COV_BLUR = 0.3        # low-pass dilation added to the 2D covariance (3DGS std)
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99


@dataclasses.dataclass(frozen=True)
class Splats:
    """Projected 2D Gaussians in widened-left pixel coordinates."""

    mean2d: torch.Tensor     # (M, 2)
    depth: torch.Tensor      # (M,) camera z (same for both eyes)
    conic: torch.Tensor      # (M, 3) inverse covariance (A, B, C)
    ext: torch.Tensor        # (M, 2) half-extents of the α ≥ α_min ellipse
    color_l: torch.Tensor    # (M, 3)
    color_r: torch.Tensor    # (M, 3)
    opacity: torch.Tensor    # (M,)
    disparity: torch.Tensor  # (M,) B·f/z ≥ 0
    visible: torch.Tensor    # (M,) bool

    @property
    def m(self) -> int:
        return self.mean2d.shape[0]


def project(g: Gaussians, rig: StereoRig, wide: Camera) -> Splats:
    """EWA projection of the render queue onto the widened camera (K3 on
    CUDA tensors, its plain version on CPU tensors)."""
    from repro_torch.kernels.preprocess import preprocess
    return preprocess(g, rig, wide)


def depth_ranks(s: Splats) -> torch.Tensor:
    """(M,) int32 front-to-back rank shared by both eyes (invisible last;
    ties broken by index)."""
    key = torch.where(s.visible, s.depth, torch.full_like(s.depth, float("inf")))
    order = torch.argsort(key, stable=True)
    ranks = torch.empty((s.m,), dtype=torch.int32, device=key.device)
    ranks[order] = torch.arange(s.m, dtype=torch.int32, device=key.device)
    return ranks
