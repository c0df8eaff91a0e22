"""Client render subsystem: stereo rasterization from projection to pixels
(port of `repro.render`).

    common  — the one definition of eye-view selection + the α test
    config  — RenderConfig: static tile/resolution/stereo geometry
    plan    — RenderPlan, StereoFrameStats
    stages  — project / bin_shared / stereo_merge / rasterize,
              render_stereo(plan), the plain rasterizers
    batched — fleet rendering, per client or pooled into one K2 launch
"""

from repro_torch.render.common import entry_alpha, eye_views, pixel_alpha, splat_alpha
from repro_torch.render.config import RenderConfig
from repro_torch.render.plan import RenderPlan, StereoFrameStats, frame_stats
from repro_torch.render.stages import (bin_shared, build_plan, project, rasterize,
                                       render_reference, render_stereo,
                                       render_stereo_reference, render_tiles,
                                       stereo_merge)
from repro_torch.render.batched import (batched_build_plans, batched_render_stereo,
                                        stack_rigs)

__all__ = [
    "entry_alpha", "eye_views", "pixel_alpha", "splat_alpha",
    "RenderConfig", "RenderPlan", "StereoFrameStats", "frame_stats",
    "project", "bin_shared", "stereo_merge", "rasterize", "build_plan",
    "render_stereo", "render_stereo_reference", "render_tiles", "render_reference",
    "batched_build_plans", "batched_render_stereo", "stack_rigs",
]
