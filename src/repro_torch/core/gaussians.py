"""Gaussian primitive container + procedural city-scale scene generation.

Port of `repro.core.gaussians`. The scene generator is numpy (an offline
step) and consumes its `Generator` exactly as the reference does, so a seed
gives the same leaves bit for bit; only the final arrays become tensors on
the requested device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.numerics import fma32, sqrt_rn

# SH constants (degree <= 2 supported by the kernels; default degree 1).
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199


def sh_dim(degree: int) -> int:
    return (degree + 1) ** 2


@dataclasses.dataclass(frozen=True)
class Gaussians:
    """Structure-of-arrays Gaussian container.

    mu:        (N, 3) float32 world-space centers
    log_scale: (N, 3) float32 per-axis log std-dev
    quat:      (N, 4) float32 rotation quaternion (w, x, y, z), normalized
    opacity:   (N,)   float32 in (0, 1)
    sh:        (N, K, 3) float32 spherical-harmonic color coefficients
    """

    mu: torch.Tensor
    log_scale: torch.Tensor
    quat: torch.Tensor
    opacity: torch.Tensor
    sh: torch.Tensor

    @property
    def n(self) -> int:
        return self.mu.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(np.sqrt(self.sh.shape[1])) - 1

    @property
    def device(self) -> torch.device:
        return self.mu.device

    def __getitem__(self, idx) -> "Gaussians":
        return Gaussians(mu=self.mu[idx], log_scale=self.log_scale[idx],
                         quat=self.quat[idx], opacity=self.opacity[idx],
                         sh=self.sh[idx])

    def slice_rows(self, idx: torch.Tensor) -> "Gaussians":
        """Gather rows by an index tensor."""
        idx = idx.long()
        return Gaussians(
            mu=self.mu.index_select(0, idx),
            log_scale=self.log_scale.index_select(0, idx),
            quat=self.quat.index_select(0, idx),
            opacity=self.opacity.index_select(0, idx),
            sh=self.sh.index_select(0, idx),
        )

    @staticmethod
    def concat(parts: Tuple["Gaussians", ...]) -> "Gaussians":
        return Gaussians(
            mu=torch.cat([p.mu for p in parts], 0),
            log_scale=torch.cat([p.log_scale for p in parts], 0),
            quat=torch.cat([p.quat for p in parts], 0),
            opacity=torch.cat([p.opacity for p in parts], 0),
            sh=torch.cat([p.sh for p in parts], 0),
        )

    def to(self, device) -> "Gaussians":
        return Gaussians(mu=self.mu.to(device), log_scale=self.log_scale.to(device),
                         quat=self.quat.to(device), opacity=self.opacity.to(device),
                         sh=self.sh.to(device))

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.mu, self.log_scale, self.quat, self.opacity, self.sh))


def bytes_per_gaussian(sh_degree: int, raw: bool = True) -> int:
    """Uncompressed storage per Gaussian in float32 (mu3+ls3+q4+op1 + sh)."""
    return 4 * (3 + 3 + 4 + 1 + 3 * sh_dim(sh_degree))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(…, 4) wxyz quaternion → (…, 3, 3) rotation matrix.

    The norm is accumulated as the chain q0² → fma(q1,q1,·) → fma(q2,q2,·) →
    fma(q3,q3,·): that is how the reference's compiled reduction rounds on
    the CPU, and `build_lod_tree` needs its bits (the merged parents'
    covariances derive from these rotations)."""
    s = q[..., 0] * q[..., 0]
    for i in (1, 2, 3):
        s = fma32(q[..., i], q[..., i], s)
    q = q / (sqrt_rn(s)[..., None] + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def covariance(g: Gaussians) -> torch.Tensor:
    """(N, 3, 3) world-space covariance R S S^T R^T."""
    rot = quat_to_rotmat(g.quat)
    rs = rot * torch.exp(g.log_scale)[..., None, :]
    return rs @ rs.transpose(-1, -2)


def eval_sh(sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH color along unit view directions: sh (..., K, 3), dirs (..., 3) →
    (..., 3) RGB clipped at 0. K in {1, 4, 9}."""
    k = sh.shape[-2]
    c = SH_C0 * sh[..., 0, :]
    x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    if k >= 4:
        c = c - SH_C1 * y * sh[..., 1, :] + SH_C1 * z * sh[..., 2, :] - SH_C1 * x * sh[..., 3, :]
    if k >= 9:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        c = (c
             + 1.0925484305920792 * xy * sh[..., 4, :]
             + (-1.0925484305920792) * yz * sh[..., 5, :]
             + 0.31539156525252005 * (2.0 * zz - xx - yy) * sh[..., 6, :]
             + (-1.0925484305920792) * xz * sh[..., 7, :]
             + 0.5462742152960396 * (xx - yy) * sh[..., 8, :])
    if k > 9:
        raise ValueError(f"SH with K={k} coefficients is not supported (degree <= 2)")
    return torch.clamp_min(c + 0.5, 0.0)


# ---------------------------------------------------------------------------
# Procedural city scene
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CityConfig:
    """Procedural city parameters (world units are meters)."""

    blocks_x: int = 4
    blocks_y: int = 4
    block_size: float = 40.0
    street_width: float = 12.0
    max_height: float = 45.0
    leaf_density: float = 0.6       # Gaussians per square meter of surface
    sh_degree: int = 1
    seed: int = 0

    @property
    def extent(self) -> Tuple[float, float]:
        pitch = self.block_size + self.street_width
        return (self.blocks_x * pitch, self.blocks_y * pitch)


def _surface_points(rng: np.random.Generator, n: int, origin, u_vec, v_vec) -> np.ndarray:
    uv = rng.random((n, 2))
    return (np.asarray(origin)[None, :]
            + uv[:, :1] * np.asarray(u_vec)[None, :]
            + uv[:, 1:] * np.asarray(v_vec)[None, :])


def gaussians_from_numpy(mu, log_scale, quat, opacity, sh, device) -> Gaussians:
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    return Gaussians(mu=t(mu), log_scale=t(log_scale), quat=t(quat),
                     opacity=t(opacity), sh=t(sh))


def generate_city(cfg: CityConfig, device: DeviceLike = None) -> Gaussians:
    """Leaf Gaussians for a procedural city (numpy offline step, then moved
    to `device`)."""
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    pitch = cfg.block_size + cfg.street_width
    pts, scales, colors = [], [], []

    def add_patch(origin, u_vec, v_vec, base_color, scale_m):
        area = np.linalg.norm(np.cross(u_vec, v_vec))
        n = max(4, int(area * cfg.leaf_density))
        pts.append(_surface_points(rng, n, origin, u_vec, v_vec))
        scales.append(np.full((n, 3), scale_m) * rng.uniform(0.6, 1.6, (n, 3)))
        colors.append(np.clip(base_color + rng.normal(0, 0.08, (n, 3)), 0.02, 0.98))

    ex, ey = cfg.extent
    n_ground = max(16, int(ex * ey * cfg.leaf_density * 0.08))
    gp = rng.random((n_ground, 2)) * np.array([ex, ey])
    pts.append(np.concatenate([gp, np.zeros((n_ground, 1))], axis=1))
    scales.append(np.full((n_ground, 3), 1.2) * rng.uniform(0.7, 1.4, (n_ground, 3)))
    colors.append(np.clip(0.35 + rng.normal(0, 0.05, (n_ground, 3)), 0.05, 0.9))

    for bx in range(cfg.blocks_x):
        for by in range(cfg.blocks_y):
            x0 = bx * pitch + cfg.street_width / 2
            y0 = by * pitch + cfg.street_width / 2
            w = cfg.block_size * rng.uniform(0.5, 0.95)
            d = cfg.block_size * rng.uniform(0.5, 0.95)
            h = cfg.max_height * rng.uniform(0.15, 1.0)
            base = np.clip(rng.uniform(0.25, 0.8, 3), 0, 1)
            sc = 0.8
            add_patch([x0, y0, 0], [w, 0, 0], [0, 0, h], base, sc)
            add_patch([x0, y0 + d, 0], [w, 0, 0], [0, 0, h], base * 0.9, sc)
            add_patch([x0, y0, 0], [0, d, 0], [0, 0, h], base * 0.95, sc)
            add_patch([x0 + w, y0, 0], [0, d, 0], [0, 0, h], base * 0.85, sc)
            add_patch([x0, y0, h], [w, 0, 0], [0, d, 0], base * 1.1, sc)

    mu = np.concatenate(pts, axis=0).astype(np.float32)
    scale = np.concatenate(scales, axis=0).astype(np.float32)
    col = np.concatenate(colors, axis=0).astype(np.float32)
    n = mu.shape[0]

    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    opacity = rng.uniform(0.35, 0.95, n).astype(np.float32)

    k = sh_dim(cfg.sh_degree)
    sh = np.zeros((n, k, 3), dtype=np.float32)
    sh[:, 0, :] = (col - 0.5) / SH_C0
    if k > 1:
        n_mat = 32
        protos = rng.normal(0, 0.12, (n_mat, k - 1, 3))
        mat = rng.integers(0, n_mat, n)
        sh[:, 1:, :] = protos[mat] + rng.normal(0, 0.015, (n, k - 1, 3))

    return gaussians_from_numpy(mu, np.log(np.maximum(scale, 1e-4)), quat,
                                opacity, sh, device)


def random_gaussians(rng: np.random.Generator, n: int, sh_degree: int = 1,
                     extent: float = 10.0, device: DeviceLike = None) -> Gaussians:
    """Uniform random Gaussians (unit tests and kernel sweeps)."""
    device = resolve_device(device)
    k = sh_dim(sh_degree)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True) + 1e-12
    mu = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    log_scale = np.log(rng.uniform(0.05, 0.6, (n, 3))).astype(np.float32)
    opacity = rng.uniform(0.2, 0.95, n).astype(np.float32)
    sh = rng.normal(0, 0.35, (n, k, 3)).astype(np.float32)
    return gaussians_from_numpy(mu, log_scale, quat, opacity, sh, device)
