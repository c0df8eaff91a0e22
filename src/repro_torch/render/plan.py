"""RenderPlan — everything the rasterization stage needs (port of
`repro.render.plan`): projected splats, the shared front-to-back depth
ranks, and both eyes' tile lists. `StereoFrameStats` is the tensor-valued
per-frame accounting that the fleet render stacks per client."""

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

    @property
    def overflow(self) -> torch.Tensor:
        """() bool: any budget (pairs, list, merge) exceeded anywhere."""
        return self.left.overflow | self.right.overflow


@dataclasses.dataclass(frozen=True)
class StereoFrameStats:
    """One stereo frame's work-sharing accounting, as 0-d tensors.

    shared_preprocess:   int32 — splats projected once instead of twice
    left_blends:         int32 — (tile, entry) pairs blended, left eye
    right_candidates:    int32 — entries merged for the right eye
    right_alpha_skipped: int32 — right candidates prunable by the left α-check
    overflow:            bool  — any plan budget exceeded
    """

    shared_preprocess: torch.Tensor
    left_blends: torch.Tensor
    right_candidates: torch.Tensor
    right_alpha_skipped: torch.Tensor
    overflow: torch.Tensor


def frame_stats(plan: RenderPlan, left_hits: torch.Tensor) -> StereoFrameStats:
    """Tensor-valued counterpart of `core.stereo.alpha_skip_stats` (the
    paper's step-② forwarding accounting)."""
    s = plan.splats
    m = s.m
    hit_any = torch.zeros((m + 1,), dtype=torch.bool, device=left_hits.device)
    g = torch.where(plan.left.lists >= 0, plan.left.lists, m).long().reshape(-1)
    hit_any[g[left_hits.reshape(-1)]] = True
    r_valid = plan.right.lists >= 0
    r_hit = hit_any[torch.where(r_valid, plan.right.lists, m).long()] & r_valid
    return StereoFrameStats(
        shared_preprocess=s.visible.sum().to(torch.int32),
        left_blends=(plan.left.lists >= 0).sum().to(torch.int32),
        right_candidates=r_valid.sum().to(torch.int32),
        right_alpha_skipped=(r_valid & ~r_hit).sum().to(torch.int32),
        overflow=plan.left.overflow | plan.right.overflow,
    )
