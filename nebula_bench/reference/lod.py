"""The LoD cut, searched over the whole tree from its root (paper §4.2):

    proj(n)   = size(n) · focal / max(‖mu(n) − cam‖, 1e-6)
    expand(n) = expand(parent(n)) and proj(n) > τ        (the root's parent expands)
    in_cut(n) = expand(parent(n)) and (proj(n) ≤ τ or n is a leaf)

in float32, the distance's squares summed as x², then y² and z² each added
with one rounding, as the configuration's float32 arithmetic states it.
No slabs, no temporal reuse: a cut is a function of the camera alone."""

from __future__ import annotations

import torch

_EPS_DIST = 1e-6


class Tree:
    """The scene's level-major tree on `device` in `dtype`."""

    def __init__(self, scene, device, dtype=torch.float32):
        self.dtype = dtype
        self.pid = torch.as_tensor(scene.pid, device=device)
        self.mu = torch.as_tensor(scene.padded["mu"], device=device)[self.pid].to(dtype)
        self.size = torch.as_tensor(scene.padded["size"], device=device)[self.pid].to(dtype)
        self.parent = torch.as_tensor(scene.parent, device=device)
        self.is_leaf = torch.as_tensor(scene.is_leaf, device=device)
        self.offs = scene.level_offsets
        self.n_pad = scene.n_pad
        levels = torch.zeros(scene.n_pad, dtype=torch.int64, device=device)
        for lv in range(len(self.offs) - 1):
            levels[self.pid[self.offs[lv]:self.offs[lv + 1]]] = lv
        self.level_of_row = levels     # tree depth of each padded row

    def distance(self, cam: torch.Tensor) -> torch.Tensor:
        d = self.mu - cam.to(self.dtype)
        if self.dtype != torch.float32:
            return torch.sqrt((d * d).sum(1))
        s = d[:, 0] * d[:, 0]
        for i in (1, 2):
            s = (d[:, i].double() * d[:, i].double() + s.double()).float()
        return torch.sqrt(s.double()).float()

    def cut(self, cam: torch.Tensor, focal: float, tau: float) -> torch.Tensor:
        """(n_pad,) bool cut mask in the program's padded row order."""
        dist = self.distance(cam)
        tau_t = torch.tensor(tau, dtype=torch.float32).to(self.dtype).item()
        gt = self.size * focal / torch.clamp_min(dist, _EPS_DIST) > tau_t
        expand = torch.zeros_like(gt)
        in_cut = torch.zeros_like(gt)
        for lv in range(len(self.offs) - 1):
            lo, hi = self.offs[lv], self.offs[lv + 1]
            pe = (torch.ones(hi - lo, dtype=torch.bool, device=gt.device) if lv == 0
                  else expand[self.parent[lo:hi]])
            expand[lo:hi] = pe & gt[lo:hi]
            in_cut[lo:hi] = pe & (~gt[lo:hi] | self.is_leaf[lo:hi])
        out = torch.zeros(self.n_pad, dtype=torch.bool, device=gt.device)
        out[self.pid] = in_cut
        return out
