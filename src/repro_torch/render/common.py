"""Shared per-splat shading math — the one definition of eye-view selection
and the α test (port of `repro.render.common`). The stereo bit-accuracy
property holds because every rasterization path evaluates exactly this
expression, in this order; the CUDA raster kernel writes the same sequence.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.projection import ALPHA_MAX, ALPHA_MIN, Splats


def eye_views(s: Splats, eye: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(means, colors) for the requested eye. Right = x_R = x_L − B·f/z."""
    if eye == "left":
        return s.mean2d, s.color_l
    shift = torch.stack([s.disparity, torch.zeros_like(s.disparity)], -1)
    return s.mean2d - shift, s.color_r


def splat_alpha(dx, dy, conic_a, conic_b, conic_c, opacity, *,
                alpha_min: float = ALPHA_MIN, alpha_max: float = ALPHA_MAX):
    """α of one splat at pixel offset (dx, dy) from its center.

    Op order is load-bearing: `opacity * exp(-power)` then the min and the
    threshold."""
    power = 0.5 * (conic_a * dx * dx + 2.0 * conic_b * dx * dy
                   + conic_c * dy * dy)
    a = opacity * torch.exp(-power)
    a = torch.clamp_max(a, alpha_max)
    return torch.where(a >= alpha_min, a, torch.zeros_like(a))


def pixel_alpha(px: torch.Tensor, mean: torch.Tensor, conic: torch.Tensor,
                opacity: torch.Tensor, *, alpha_min: float = ALPHA_MIN,
                alpha_max: float = ALPHA_MAX) -> torch.Tensor:
    """α at pixel centers px (..., 2) for one splat (mean (2,), conic (3,))."""
    d = px - mean
    return splat_alpha(d[..., 0], d[..., 1], conic[0], conic[1], conic[2],
                       opacity, alpha_min=alpha_min, alpha_max=alpha_max)


def entry_alpha(px, py, entry, *, alpha_min: float = ALPHA_MIN,
                alpha_max: float = ALPHA_MAX):
    """α for pre-gathered entry rows [..., 9] = [mx, my, ca, cb, cc, r, g, b,
    opa]; px/py broadcast against the entry's leading axes."""
    return splat_alpha(px - entry[..., 0], py - entry[..., 1], entry[..., 2],
                       entry[..., 3], entry[..., 4], entry[..., 8],
                       alpha_min=alpha_min, alpha_max=alpha_max)
