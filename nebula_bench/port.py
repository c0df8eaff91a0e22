"""The benchmark's inputs in the program's types: the scene's arrays as the
port's `LodTree`, and a frame's pose as its `StereoRig`. The only module of
the benchmark, with the kinds' drivers, that imports the program."""

from __future__ import annotations

import torch

from repro_torch.core.camera import Camera, StereoRig
from repro_torch.core.gaussians import Gaussians
from repro_torch.core.lod_tree import LodTree, TreeMeta


def build_kernels(device) -> dict:
    """The port's CUDA library, built into the checkout's `build/` on a
    checkout's first run (nothing on the CPU)."""
    if device.type != "cuda":
        return {}
    from repro_torch.kernels import _build
    b = _build.build()
    _build.library()
    return dict(rebuilt=bool(b["rebuilt"]), build_s=float(b["seconds"]))


def lod_tree(scene, device) -> LodTree:
    p = scene.padded

    def t(name):
        return torch.as_tensor(p[name], device=device).contiguous()

    meta = TreeMeta(**scene.meta)
    return LodTree(gaussians=Gaussians(mu=t("mu"), log_scale=t("log_scale"), quat=t("quat"),
                                       opacity=t("opacity"), sh=t("sh")),
                   size=t("size"), top_parent=t("top_parent"), top_is_leaf=t("top_is_leaf"),
                   slab_parent=t("slab_parent"), slab_is_leaf=t("slab_is_leaf"),
                   slab_valid=t("slab_valid"), slab_level=t("slab_level"),
                   slab_root_parent_top=t("slab_root_parent_top"), meta=meta)


class Rigs:
    """Poses of one headset on the device, as the program's stereo rigs."""

    def __init__(self, rig: dict, pos, rot, device):
        self.rig = rig
        self.pos = torch.as_tensor(pos, device=device)
        self.rot = torch.as_tensor(rot, device=device)
        self.focal = torch.tensor(float(rig["focal"]), dtype=torch.float32, device=device)

    def __len__(self) -> int:
        return self.pos.shape[0]

    def extend(self, pos, rot) -> None:
        self.pos = torch.cat([self.pos, torch.as_tensor(pos, device=self.pos.device)])
        self.rot = torch.cat([self.rot, torch.as_tensor(rot, device=self.rot.device)])

    def __getitem__(self, f: int) -> StereoRig:
        r = self.rig
        cam = Camera(pos=self.pos[f], rot=self.rot[f], focal=self.focal, width=r["width"],
                     height=r["height"], near=r["near"], far=r["far"],
                     cx=r["width"] / 2.0, cy=r["height"] / 2.0)
        return StereoRig(left=cam, baseline=r["baseline"])
