"""Headset motion: the one generator every traffic mix's data file drives.

A headset moves along a street of the city's grid at a steady speed, at
eye height with a head bob, and turns its head about the street's heading
(a sinusoid whose peak rate is `yaw_rate_dps`). The street, the direction,
the start along it, the lateral place in the street and the phase of the
head's turn are drawn from the seed and the client's index. At the city's
edge (5% of its extent) the headset turns back along the same street. A
frame advances the headset 1/fps seconds of its own time, whatever the
program's speed, so the traffic advances by frames and not by wall time.

Parameters (a traffic mix's `.json` file): `fps`, `speed_mps`,
`yaw_rate_dps`, `yaw_hz`, `head_bob_hz`, `head_bob_m`, `eye_height`,
`look_down` (the view's downward slope), `frames` (poses made at set-up;
more are made if a window needs them).
"""

from __future__ import annotations

import numpy as np


def look_at(pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """(n, 3, 3) float32 camera-to-world rotations (columns: right, down,
    forward) of cameras at `pos` looking at `target`, world z up."""
    fwd = target - pos
    fwd /= np.linalg.norm(fwd, axis=1, keepdims=True) + 1e-12
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd], axis=2).astype(np.float32)


def _triangle(s: np.ndarray, lo: float, hi: float):
    """Reflect positions `s` into [lo, hi]; also the sign of travel."""
    span = hi - lo
    u = np.mod(s - lo, 2 * span)
    back = u > span
    return lo + np.where(back, 2 * span - u, u), np.where(back, -1.0, 1.0)


class Headset:
    """One headset's path through `city` (the configuration's `city` block)."""

    def __init__(self, traffic: dict, city: dict, seed: int, client: int):
        rng = np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), 2, client]))
        self.t = traffic
        pitch = city["block_size"] + city["street_width"]
        self.extent = (city["blocks_x"] * pitch, city["blocks_y"] * pitch)
        self.axis = int(rng.integers(0, 2))            # 0: along x, 1: along y
        n_streets = (city["blocks_y"], city["blocks_x"])[self.axis]
        street = int(rng.integers(1, max(n_streets, 2)))
        self.cross = street * pitch + rng.uniform(-0.25, 0.25) * city["street_width"]
        length = self.extent[self.axis]
        self.lo, self.hi = 0.05 * length, 0.95 * length
        self.s0 = rng.uniform(self.lo, self.hi)
        self.dir = 1.0 if rng.integers(0, 2) else -1.0
        self.phase = rng.uniform(0, 2 * np.pi)

    def poses(self, first: int, count: int):
        """Positions (count, 3) and rotations (count, 3, 3), float32, of
        frames first .. first + count - 1."""
        tr = self.t
        time = np.arange(first, first + count, dtype=np.float64) / tr["fps"]
        s, sign = _triangle(self.s0 + self.dir * tr["speed_mps"] * time, self.lo, self.hi)
        heading = (0.0 if self.axis == 0 else np.pi / 2) + np.where(
            sign * self.dir > 0, 0.0, np.pi)
        amp = np.deg2rad(tr["yaw_rate_dps"]) / (2 * np.pi * tr["yaw_hz"])
        heading = heading + amp * np.sin(2 * np.pi * tr["yaw_hz"] * time + self.phase)
        pos = np.zeros((count, 3))
        pos[:, self.axis] = s
        pos[:, 1 - self.axis] = self.cross
        pos[:, 2] = tr["eye_height"] + tr["head_bob_m"] * np.sin(
            2 * np.pi * tr["head_bob_hz"] * time)
        target = pos + np.stack([np.cos(heading), np.sin(heading),
                                 np.full(count, -tr["look_down"])], 1)
        return pos.astype(np.float32), look_at(pos, target)
