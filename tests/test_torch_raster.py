"""Port parity: tile rasterization (K2's plain version) of `repro_torch`
against the JAX package's oracle and Pallas kernel (interpret mode), and the
stereo bit-accuracy property reproduced inside the port."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close, assert_equal, np_, to_torch_splats,
                           to_torch_tile_lists)

from repro.core import binning as jbin
from repro.core import stereo as jst
from repro.core.camera import StereoRig, make_camera
from repro.core.gaussians import random_gaussians
from repro.core.projection import depth_ranks, project
from repro.kernels import ops as kops
from repro.kernels import ref as kref
from repro.kernels.rasterize import rasterize_tiles_pallas
from repro.render.stages import render_tiles as j_render_tiles
from repro_torch import kernels as tkernels
from repro_torch.core import gaussians as tg
from repro_torch.core import pipeline as tpipe
from repro_torch.core.camera import StereoRig as TStereoRig
from repro_torch.core.camera import make_camera as t_make_camera
from repro_torch.kernels import rasterize as traster
from repro_torch.render import stages as tstages


def _scene(n, seed):
    g = random_gaussians(np.random.default_rng(seed), n, sh_degree=1, extent=5.0)
    cam = make_camera([0, -15, 2], [0, 0, 0], focal_px=200.0, width=96, height=64,
                      near=0.25)
    rig = StereoRig(left=cam, baseline=0.06)
    n_cat = jst.n_categories(rig.max_disparity_px(), 16)
    wide = dataclasses.replace(cam, width=(6 + n_cat - 1) * 16)
    s = project(g, rig, wide)
    lists = jbin.bin_left(s, wide.width, cam.height,
                          jbin.BinConfig(tile=16, max_pairs=1 << 14, list_len=64),
                          depth_ranks(s))
    return cam, s, lists


@pytest.mark.parametrize("n,seed", [(100, 0), (300, 1), (800, 2)])
def test_raster_kernel_plain_matches_reference(n, seed):
    """Same entries, counts and origins: image at rtol 1e-5 / atol 1e-6 and
    hits exact against the JAX oracle and the Pallas kernel."""
    cam, s, lists = _scene(n, seed)
    entries, counts = kops.gather_entries(lists, s, "left")
    t_entries, t_counts = traster.gather_entries(to_torch_tile_lists(lists),
                                                 to_torch_splats(s), "left")
    assert_equal(t_entries, entries)
    assert_equal(t_counts, counts)
    origins = traster.tile_origins(t_entries.shape[0], lists.tiles_x, 16, CPU)
    tkernels.reset_launch_counts()
    img, hits = traster.rasterize_slabs(t_entries, t_counts, origins, tile=16)
    assert tkernels.launch_counts()["rasterize_slabs"] == 0  # CPU: plain version
    ref_img, ref_hits = kref.ref_rasterize_slabs(entries, counts, jnp.asarray(np_(origins)),
                                                 tile=16)
    refs = [(ref_img, ref_hits)]
    if n == 300:  # the Pallas kernel in interpret mode (slow to trace): one shape
        refs.append(rasterize_tiles_pallas(entries, counts, tile=16, tiles_x=lists.tiles_x))
    for r_img, r_hits in refs:
        assert_close(img, r_img, 1e-5, 1e-6)
        assert_equal(hits, r_hits)


def test_raster_both_eyes_match_render_tiles():
    cam, s, lists = _scene(400, 3)
    ts, tl = to_torch_splats(s), to_torch_tile_lists(lists)
    kw = dict(width=cam.width, height=cam.height, tile=16)
    for eye in ("left", "right"):
        img, hits = traster.rasterize(tl, ts, eye=eye, **kw)
        ref_img, ref_hits = j_render_tiles(lists, s, eye=eye, **kw)
        assert_close(img, ref_img, 1e-5, 1e-6)
        assert_equal(hits, ref_hits)
        plain_img, plain_hits = tstages.render_tiles(tl, ts, eye=eye, **kw)
        assert_close(plain_img, ref_img, 1e-5, 1e-6)
        assert_equal(plain_hits, ref_hits)


def test_early_termination_bounded():
    cam, s, lists = _scene(800, 4)
    ts, tl = to_torch_splats(s), to_torch_tile_lists(lists)
    kw = dict(width=cam.width, height=cam.height, tile=16, eye="left")
    img0, _ = traster.rasterize(tl, ts, eps_t=0.0, **kw)
    img1, _ = traster.rasterize(tl, ts, eps_t=1e-3, **kw)
    assert float((img0 - img1).abs().max()) <= 1e-3 + 1e-6


@pytest.mark.parametrize("eps_t", [0.0, 0.05])
def test_processed_entries_are_where_tiles_stop(eps_t):
    """The plain version's per-tile count of blended entries: no hit lies at
    or past it, and blending only that many entries gives the same image."""
    cam, s, lists = _scene(800, 5)
    ent, counts = traster.gather_entries(to_torch_tile_lists(lists), to_torch_splats(s),
                                         "left")
    origins = traster.tile_origins(ent.shape[0], lists.tiles_x, 16, CPU)
    img, hits, done = traster.rasterize_slabs_plain(ent, counts, origins, tile=16,
                                                    eps_t=eps_t, with_processed=True)
    assert bool((done <= counts).all()) and int(done.sum()) > 0
    if eps_t > 0:
        assert bool((done < counts).any())  # some tile stopped early
    past = torch.arange(ent.shape[1])[None, :] >= done[:, None]
    assert not bool(hits[past].any())
    img2, hits2 = traster.rasterize_slabs_plain(ent, done, origins, tile=16, eps_t=eps_t)
    assert_equal(img2, img)
    assert_equal(hits2, hits)


def _trig(baseline=0.06):
    cam = t_make_camera([0, -18, 2], [0, 0, 0], focal_px=220.0, width=128, height=96,
                        near=0.2, device=CPU)
    return TStereoRig(left=cam, baseline=baseline)


@pytest.mark.parametrize("n,seed,sh_degree,tile", [(200, 0, 1, 16), (600, 1, 1, 16),
                                                   (400, 7, 2, 8)])
def test_stereo_bit_accurate_in_torch(n, seed, sh_degree, tile):
    """At eps_t = 0 with clean overflow flags, the port's tiled stereo render
    (left raster + shift-merged right eye) equals its untiled per-pixel
    reference bit for bit in both eyes."""
    g = tg.random_gaussians(np.random.default_rng(seed), n, sh_degree=sh_degree,
                            extent=6.0, device=CPU)
    rig = _trig()
    il, ir, (_s, ll, rl, _st) = tpipe.render_stereo(g, rig, tile=tile, list_len=256,
                                                    max_pairs=1 << 16)
    assert not bool(ll.overflow) and not bool(rl.overflow)
    ref_l, ref_r = tpipe.render_stereo_reference(g, rig)
    assert_equal(il, ref_l)
    assert_equal(ir, ref_r)
    assert float(il.max()) > 0 and float(ir.max()) > 0

