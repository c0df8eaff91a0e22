"""Tile rasterization — the import shim over `repro_torch.render`, as the
JAX package keeps one over `repro.render`:

    repro_torch.core.raster.render_tiles      -> repro_torch.render.stages.render_tiles
    repro_torch.core.raster.render_reference  -> repro_torch.render.stages.render_reference
    repro_torch.core.raster.eye_views         -> repro_torch.render.common.eye_views
    repro_torch.core.raster._alpha            -> repro_torch.render.common.pixel_alpha
"""

from __future__ import annotations

from repro_torch.render.common import eye_views, pixel_alpha
from repro_torch.render.stages import render_reference, render_tiles

_alpha = pixel_alpha

__all__ = ["eye_views", "pixel_alpha", "_alpha", "render_tiles",
           "render_reference"]
