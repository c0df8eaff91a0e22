"""RenderPlan — everything the rasterization stage needs (port of
`repro.render.plan`): projected splats, the shared front-to-back depth
ranks, and both eyes' tile lists."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.binning import TileLists
from repro_torch.core.projection import Splats


@dataclasses.dataclass(frozen=True)
class RenderPlan:
    """splats: projected 2D Gaussians on the widened-left plane; ranks: (M,)
    shared depth ranks; left: widened-grid tile lists (binning); right:
    right-eye tile lists (shift-merge)."""

    splats: Splats
    ranks: torch.Tensor
    left: TileLists
    right: TileLists
