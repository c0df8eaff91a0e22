"""Port parity: scene generation, Gaussian math and the LoD tree construction of
`repro_torch` against the JAX package, on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, TREE_FIELDS, assert_close, assert_equal,
                           gaussians_arrays, np_, to_torch_gaussians, tree_arrays)

from repro.core import camera as jcam
from repro.core import gaussians as jg
from repro.core.lod_tree import build_lod_tree as jbuild
from repro_torch import device as tdevice
from repro_torch.core import camera as tcam
from repro_torch.core import gaussians as tg
from repro_torch.core.lod_tree import build_lod_tree as tbuild


def test_generate_city_seed_for_seed():
    cfg = dict(blocks_x=2, blocks_y=3, leaf_density=0.1, seed=3)
    ref = jg.generate_city(jg.CityConfig(**cfg))
    got = tg.generate_city(tg.CityConfig(**cfg), device=CPU)
    for k, v in gaussians_arrays(ref).items():
        assert_equal(getattr(got, k), v, k)


@pytest.mark.parametrize("sh_degree", [0, 1, 2])
def test_random_gaussians_and_sh(sh_degree):
    ref = jg.random_gaussians(np.random.default_rng(5), 257, sh_degree=sh_degree)
    got = tg.random_gaussians(np.random.default_rng(5), 257, sh_degree=sh_degree,
                              device=CPU)
    for k, v in gaussians_arrays(ref).items():
        assert_equal(getattr(got, k), v, k)
    dirs = np.random.default_rng(6).normal(size=(257, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    assert_close(tg.eval_sh(got.sh, torch.from_numpy(dirs)),
                 jg.eval_sh(ref.sh, jnp.asarray(dirs)), 1e-6, 1e-6)
    assert_close(tg.covariance(got), jg.covariance(ref), 1e-5, 1e-6)


def test_quat_to_rotmat_bitwise():
    """`build_lod_tree`'s one float32 tensor step rounds as the reference's."""
    q = np.random.default_rng(0).normal(size=(50000, 4)).astype(np.float32)
    assert_equal(tg.quat_to_rotmat(torch.from_numpy(q)), jg.quat_to_rotmat(jnp.asarray(q)))


def test_gaussians_slice_concat():
    g = tg.random_gaussians(np.random.default_rng(1), 20, device=CPU)
    idx = torch.tensor([3, 0, 7])
    part = g.slice_rows(idx)
    assert_equal(part.mu, g.mu[idx])
    both = tg.Gaussians.concat((part, g[5:9]))
    assert both.n == 7 and both.sh_degree == 1
    assert_equal(both.opacity[3:], g.opacity[5:9])


@pytest.mark.parametrize("which", ["small", "tiny"])
def test_tree_arrays_equal(which, small_tree, tiny_tree, small_city):
    """Every LodTree array the port builds equals the reference's."""
    if which == "small":
        ref = small_tree
        got = tbuild(to_torch_gaussians(small_city), target_subtrees=16, seed=0,
                     device=CPU)
    else:
        leaves = jg.random_gaussians(np.random.default_rng(7), 150, sh_degree=1,
                                     extent=30.0)
        ref = tiny_tree
        got = tbuild(to_torch_gaussians(leaves), branching=(2, 4), target_subtrees=8,
                     seed=1, device=CPU)
    arrays, meta = tree_arrays(ref)
    assert dataclasses.asdict(got.meta) == meta
    for k in ("mu", "log_scale", "quat", "opacity", "sh"):
        assert_equal(getattr(got.gaussians, k), arrays[k], k)
    for k in TREE_FIELDS:
        assert_equal(getattr(got, k), arrays[k], k)
        assert getattr(got, k).dtype == torch.tensor(arrays[k]).dtype, k
    assert_equal(got.valid_mask(), ref.valid_mask())
    assert_equal(got.node_levels(), ref.node_levels())
    assert_equal(got.slab_mu(), ref.slab_mu())


def test_camera_and_trajectory():
    traj_j = list(jcam.walk_trajectory(jcam.TrajectoryConfig(seed=2), 6, (120.0, 90.0),
                                       focal_px=300.0, width=96, height=64))
    traj_t = list(tcam.walk_trajectory(tcam.TrajectoryConfig(seed=2), 6, (120.0, 90.0),
                                       focal_px=300.0, width=96, height=64, device=CPU))
    for cj, ct in zip(traj_j, traj_t):
        assert_equal(ct.pos, cj.pos)
        assert_equal(ct.rot, cj.rot)
        assert_equal(ct.focal, cj.focal)
        assert (ct.width, ct.height, ct.cx, ct.cy, ct.near) == \
            (cj.width, cj.height, cj.cx, cj.cy, cj.near)
        rj = jcam.StereoRig(left=cj, baseline=0.06)
        rt = tcam.StereoRig(left=ct, baseline=0.06)
        assert_equal(rt.right.pos, rj.right.pos)
        assert rt.max_disparity_px() == rj.max_disparity_px()
        p = np.random.default_rng(0).normal(size=(10, 3)).astype(np.float32)
        assert_close(ct.world_to_cam(torch.from_numpy(p)), cj.world_to_cam(jnp.asarray(p)),
                     1e-6, 1e-5)
    assert tcam.VR_EYE_RES == jcam.VR_EYE_RES


def test_widened_left_matches_jax():
    """`StereoRig.widened_left`: the left camera, `max_disparity_px`
    columns wider, as JAX's."""
    cj = next(iter(jcam.walk_trajectory(jcam.TrajectoryConfig(seed=3), 1, (120.0, 90.0),
                                        focal_px=300.0, width=96, height=64)))
    ct = next(iter(tcam.walk_trajectory(tcam.TrajectoryConfig(seed=3), 1, (120.0, 90.0),
                                        focal_px=300.0, width=96, height=64, device=CPU)))
    rj, rt = jcam.StereoRig(left=cj, baseline=0.06), tcam.StereoRig(left=ct, baseline=0.06)
    d = int(np.ceil(rt.max_disparity_px()))
    wj, wt = rj.widened_left(d), rt.widened_left(d)
    assert (wt.width, wt.height, wt.cx, wt.cy, wt.near, wt.far) == \
        (wj.width, wj.height, wj.cx, wj.cy, wj.near, wj.far) == \
        (96 + d, 64, ct.cx, ct.cy, ct.near, ct.far)
    assert_equal(wt.pos, wj.pos)
    assert_equal(wt.rot, wj.rot)
    assert_equal(wt.focal, wj.focal)


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_gaussians_nbytes_match_jax(sh_degree):
    """`Gaussians.nbytes` and `bytes_per_gaussian`, as JAX's."""
    gj = jg.random_gaussians(np.random.default_rng(4), 37, sh_degree=sh_degree)
    gt = to_torch_gaussians(gj)
    assert gt.nbytes() == gj.nbytes() == 37 * tg.bytes_per_gaussian(sh_degree)
    assert tg.bytes_per_gaussian(sh_degree) == jg.bytes_per_gaussian(sh_degree)


def test_slab_gid_matches_jax(tiny_tree):
    """`LodTree.slab_gid` (scalars and arrays), as JAX's."""
    tt = tbuild(to_torch_gaussians(jg.random_gaussians(np.random.default_rng(7), 150,
                                                       sh_degree=1, extent=30.0)),
                branching=(2, 4), target_subtrees=8, seed=1, device=CPU)
    m = tt.meta
    for s, j in [(0, 0), (m.Ns - 1, m.S - 1), (1, 2)]:
        assert tt.slab_gid(s, j) == tiny_tree.slab_gid(s, j)
    s = np.arange(m.Ns)[:, None]
    j = np.arange(m.S)[None]
    gid = tt.slab_gid(torch.from_numpy(s), torch.from_numpy(j))
    assert_equal(gid, np.asarray(tiny_tree.slab_gid(jnp.asarray(s), jnp.asarray(j))))
    assert int(gid.max()) == tt.n_pad - 1


def test_default_device_is_the_card():
    """Entry points run on the card unless asked for the CPU; without one
    they raise rather than fall back."""
    assert tdevice.resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert tdevice.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tdevice.resolve_device()
        with pytest.raises(RuntimeError):
            tg.random_gaussians(np.random.default_rng(0), 4)
