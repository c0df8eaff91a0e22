"""Pinhole + rectified stereo camera model, and VR head trajectories.

Port of `repro.core.camera`. Conventions: world is Z-up; the camera looks
along +z of its own frame (x right, y down, z forward). `rot` is the 3x3
camera-to-world rotation whose columns are the camera axes in world
coordinates.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    """Single pinhole camera.

    pos:   (3,) float32 world position
    rot:   (3, 3) float32 camera-to-world rotation (columns = cam axes)
    focal: () float32 focal length in pixels (fx == fy)
    width, height: image size in pixels; near, far: clip planes (meters);
    cx, cy: explicit principal point (widening the image plane for the
    shared stereo preprocessing does not move it).
    """

    pos: torch.Tensor
    rot: torch.Tensor
    focal: torch.Tensor
    width: int
    height: int
    near: float = 0.2
    far: float = 1000.0
    cx: float = -1.0
    cy: float = -1.0

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def world_to_cam(self, p: torch.Tensor) -> torch.Tensor:
        """(N,3) world → camera frame."""
        return (p - self.pos) @ self.rot  # rot columns are axes → p·R == R^T p

    def translated(self, offset_world: torch.Tensor) -> "Camera":
        return dataclasses.replace(self, pos=self.pos + offset_world)


@dataclasses.dataclass(frozen=True)
class StereoRig:
    """Rectified stereo pair: right camera = left translated by `baseline`
    along the camera x axis (same rotation, so depth is shared and disparity
    is baseline·focal/depth)."""

    left: Camera
    baseline: float = 0.06

    @property
    def right(self) -> Camera:
        return self.left.translated(self.left.rot[:, 0] * self.baseline)

    def max_disparity_px(self, near: float | None = None) -> float:
        """d = B f / z <= B f / near."""
        near = self.left.near if near is None else near
        return float(self.baseline) * float(self.left.focal) / near

    def widened_left(self, max_disparity_px: int) -> Camera:
        """The widened-FoV camera of shared preprocessing and binning (paper
        Fig. 13): the left camera's image plane extended to the right by
        `max_disparity_px` columns, which covers both eyes' frusta in
        left-camera pixel coordinates, [0, W + max_disp)."""
        return dataclasses.replace(self.left, width=self.left.width + int(max_disparity_px))



def look_at(pos, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Camera-to-world rotation with +z toward target, x right, y down."""
    pos = np.asarray(pos, np.float64)
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd) + 1e-12
    upv = np.asarray(up, np.float64)
    right = np.cross(fwd, upv)
    nr = np.linalg.norm(right)
    if nr < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    else:
        right /= nr
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=1).astype(np.float32)


def make_camera(pos, target, focal_px: float, width: int, height: int,
                near: float = 0.2, far: float = 2000.0,
                device: DeviceLike = None) -> Camera:
    device = resolve_device(device)
    return Camera(
        pos=torch.as_tensor(np.asarray(pos, np.float32), device=device),
        rot=torch.as_tensor(look_at(pos, target), device=device),
        focal=torch.tensor(focal_px, dtype=torch.float32, device=device),
        width=width, height=height, near=near, far=far,
        cx=width / 2.0, cy=height / 2.0,
    )


# VR resolutions (per eye). Quest-3 class default, per the paper's setup.
VR_EYE_RES = (2064, 2208)


@dataclasses.dataclass(frozen=True)
class TrajectoryConfig:
    """Street-level VR walk with head bob and smooth yaw — 90 FPS samples."""

    fps: float = 90.0
    speed_mps: float = 1.4
    yaw_rate_dps: float = 12.0
    head_bob_hz: float = 1.8
    head_bob_m: float = 0.015
    eye_height: float = 1.7
    seed: int = 0


def walk_trajectory(cfg: TrajectoryConfig, n_frames: int, extent_xy: Tuple[float, float],
                    focal_px: float = 1400.0, width: int = 512, height: int = 512,
                    device: DeviceLike = None) -> Iterator[Camera]:
    """A smooth street-level camera path inside the scene extent."""
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    ex, ey = extent_xy
    pos = np.array([ex * 0.3, ey * 0.3, cfg.eye_height])
    heading = rng.uniform(0, 2 * np.pi)
    dt = 1.0 / cfg.fps
    for t in range(n_frames):
        heading += np.deg2rad(cfg.yaw_rate_dps) * dt * np.sin(0.2 * t * dt * 2 * np.pi + 1.0)
        step = cfg.speed_mps * dt
        pos = pos + step * np.array([np.cos(heading), np.sin(heading), 0.0])
        for i, e in enumerate((ex, ey)):
            if pos[i] < 0.05 * e or pos[i] > 0.95 * e:
                heading += np.pi / 2
                pos[i] = np.clip(pos[i], 0.05 * e, 0.95 * e)
        bob = cfg.head_bob_m * np.sin(2 * np.pi * cfg.head_bob_hz * t * dt)
        p = pos + np.array([0, 0, bob])
        target = p + np.array([np.cos(heading), np.sin(heading), -0.05])
        yield make_camera(p, target, focal_px, width, height, device=device)
