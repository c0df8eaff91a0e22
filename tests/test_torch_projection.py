"""Port parity: shared stereo preprocessing (K3's plain version) and the
depth ranks of `repro_torch` against the JAX package's `project` and its
Pallas `preprocess_pallas` (interpret mode)."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (CPU, SPLAT_FIELDS, assert_close, assert_equal,
                           to_torch_gaussians, to_torch_rig, to_torch_splats)

from repro.core import projection as jproj
from repro.core.camera import StereoRig, make_camera
from repro.core.gaussians import random_gaussians
from repro.kernels import ops as kops
from repro_torch import kernels as tkernels
from repro_torch.core import projection as tproj
from repro_torch.kernels import preprocess as tpre

FLOAT_FIELDS = [f for f in SPLAT_FIELDS if f != "visible"]


def _setup(n, sh_degree, seed=None):
    rng = np.random.default_rng(n if seed is None else seed)
    g = random_gaussians(rng, n, sh_degree=sh_degree, extent=5.0)
    cam = make_camera([0, -15, 2], [0, 0, 0], focal_px=200.0, width=96, height=64,
                      near=0.25)
    rig = StereoRig(left=cam, baseline=0.06)
    wide = dataclasses.replace(cam, width=160)
    trig = to_torch_rig(rig)
    return g, rig, wide, to_torch_gaussians(g), trig, dataclasses.replace(trig.left, width=160)


@pytest.mark.parametrize("n,sh_degree", [(64, 0), (300, 1), (200, 2)])
def test_project_matches_reference(n, sh_degree):
    g, rig, wide, tg, trig, twide = _setup(n, sh_degree)
    tkernels.reset_launch_counts()
    got = tproj.project(tg, trig, twide)
    assert tkernels.launch_counts()["preprocess"] == 0  # CPU: plain version
    refs = [jproj.project(g, rig, wide)]
    if n == 300:  # the Pallas kernel in interpret mode (slow to trace): one shape
        refs.append(kops.preprocess(g, rig, wide, use_pallas=True))
    for ref in refs:
        for name in FLOAT_FIELDS:
            assert_close(getattr(got, name), getattr(ref, name), 2e-5, 2e-5, name)
        assert_equal(got.visible, ref.visible)


def test_pack_camera_layout():
    from repro.kernels.preprocess import pack_camera as jpack
    g, rig, wide, tg, trig, twide = _setup(8, 1)
    assert_close(tpre.pack_camera(trig, twide), jpack(rig, wide), 0, 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_ranks_exact(seed):
    g, rig, wide, *_ = _setup(400, 1, seed=seed)
    s = jproj.project(g, rig, wide)
    ranks = tproj.depth_ranks(to_torch_splats(s))
    assert_equal(ranks, jproj.depth_ranks(s))
    assert ranks.dtype == torch.int32


def test_unsupported_sh_degree_raises():
    _, _, _, tg, trig, twide = _setup(16, 1)
    g3 = dataclasses.replace(tg, sh=torch.zeros((16, 16, 3)))
    with pytest.raises(ValueError):
        tproj.project(g3, trig, twide)
