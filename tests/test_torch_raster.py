"""Port parity: tile rasterization (K2's plain version) of `repro_torch`
against the JAX package's oracle and Pallas kernel (interpret mode), and the
stereo bit-accuracy property reproduced inside the port."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _raster_cases import raster_cases
from _torch_parity import (CPU, assert_close, assert_equal, np_, to_torch_splats,
                           to_torch_tile_lists)

from repro.core import binning as jbin
from repro.core import stereo as jst
from repro.core.camera import StereoRig, make_camera
from repro.core.gaussians import random_gaussians
from repro.core.projection import depth_ranks, project
from repro.kernels import ops as kops
from repro.kernels import ref as kref
from repro.kernels.rasterize import rasterize_slabs_pallas, rasterize_tiles_pallas
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


def _plain_on_cases(tile, eps_t, l_len, seed=0):
    ent, counts, origins, want, want_flush = raster_cases(seed, tile, eps_t, l_len)
    img, hits, done = traster.rasterize_slabs_plain(
        torch.from_numpy(ent), torch.from_numpy(counts), torch.from_numpy(origins),
        tile=tile, eps_t=eps_t, with_processed=True)
    return (ent, counts, origins, want, want_flush), (img, hits, done)


@pytest.mark.parametrize("l_len", [256, 45])
@pytest.mark.parametrize("eps_t", [0.0, 0.02])
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_raster_adversarial_cases_plain_matches_reference(tile, eps_t, l_len):
    """K2's plain version on `tests/_raster_cases.py` (stops at and around
    the kernel's window edges, α > 0 right after each stop, count 0, -1, L,
    L + 5, NaN/inf conics and opacities): every designed stop exact, no hit
    past it, and image and hits against the JAX oracle. XLA flushes
    subnormal transmittance to 0, so at eps_t = 0 the oracle stops where
    the cases say it does, earlier than the port (ROADMAP §3); its hits are
    the port's up to that stop."""
    (ent, counts, origins, want, want_flush), (img, hits, done) = _plain_on_cases(
        tile, eps_t, l_len)
    designed = want >= 0
    assert designed.sum() >= 8
    assert_equal(done[torch.from_numpy(designed)], want[designed])
    past = torch.arange(l_len)[None, :] >= done[:, None]
    assert not bool(hits[past].any())
    assert bool(hits.any()) and bool(torch.isfinite(img).all())
    ref_img, ref_hits = kref.ref_rasterize_slabs(jnp.asarray(ent), jnp.asarray(counts),
                                                 jnp.asarray(origins), tile=tile,
                                                 eps_t=eps_t)
    assert_close(img, ref_img, 1e-5, 1e-6)
    assert (want_flush == want).all() if eps_t > 0 else (want_flush < want).any()
    stop = torch.from_numpy(np.where(want_flush >= 0, want_flush, l_len))
    assert_equal(hits & (torch.arange(l_len)[None, :] < stop[:, None]), ref_hits)


def test_raster_adversarial_cases_plain_matches_pallas():
    """The same cases against the Pallas kernel (interpret mode), on one
    shape. Tiles with count > L are left out: the Pallas kernel indexes
    entries[i] for every i < count (binning caps counts at L, so no caller
    of the reference passes more)."""
    (ent, counts, origins, *_), (img, hits, _) = _plain_on_cases(16, 0.02, 45, seed=1)
    keep = counts <= ent.shape[1]
    p_img, p_hits = rasterize_slabs_pallas(jnp.asarray(ent[keep]), jnp.asarray(counts[keep]),
                                           jnp.asarray(origins[keep]), tile=16, eps_t=0.02)
    sel = torch.from_numpy(keep)
    assert_close(img[sel], p_img, 1e-5, 1e-6)
    assert_equal(hits[sel], p_hits)


def test_raster_eps_t_at_least_one_follows_the_pallas_kernel():
    """With eps_t ≥ 1 the Pallas kernel's while-loop finds T = 1 ≤ eps_t
    before the first entry and blends nothing; the reference's oracle
    (`kref.ref_rasterize_slabs`) starts `alive` at True and blends entry 0.
    The port (plain version and kernel) follows the Pallas kernel."""
    (ent, counts, origins, want, _), (img, hits, done) = _plain_on_cases(8, 1.0, 45)
    assert not bool(done.any()) and not bool(hits.any()) and not bool(img.any())
    assert (want == 0).all()
    j = (jnp.asarray(ent), jnp.asarray(counts), jnp.asarray(origins))
    p_img, p_hits = rasterize_slabs_pallas(*j, tile=8, eps_t=1.0)
    assert_equal(img, p_img)
    assert_equal(hits, p_hits)
    _, r_hits = kref.ref_rasterize_slabs(*j, tile=8, eps_t=1.0)
    assert bool(np.asarray(r_hits)[:, 0].any()) and not bool(np.asarray(r_hits)[:, 1:].any())


def test_raster_subnormal_transmittance_is_a_difference_of_the_reference():
    """At eps_t = 0 a tile stops once T underflows to 0. XLA flushes
    subnormal floats to 0, so the JAX oracle stops as soon as T falls below
    the smallest normal float32; PyTorch and the CUDA kernel keep
    subnormals and blend on until T rounds to 0. Thirty entries of α = 0.99
    over a tile: the port blends 23, the oracle 19; the images agree (the
    extra entries add less than 1e-37)."""
    from _raster_cases import killers_needed
    ent = np.zeros((1, 30, 9), np.float32)
    ent[0, :] = [8.5, 8.5, 1e-6, 0.0, 1e-6, 0.3, 0.6, 0.9, 2.0]
    counts, origins = np.array([30], np.int32), np.zeros((1, 2), np.int32)
    img, hits, done = traster.rasterize_slabs_plain(
        torch.from_numpy(ent), torch.from_numpy(counts), torch.from_numpy(origins),
        tile=16, with_processed=True)
    k, k_flush = killers_needed(0.0), killers_needed(0.0, flush=True)
    assert (int(done[0]), k, k_flush) == (23, 23, 19)
    ref_img, ref_hits = kref.ref_rasterize_slabs(jnp.asarray(ent), jnp.asarray(counts),
                                                 jnp.asarray(origins), tile=16)
    assert np.asarray(ref_hits)[0].tolist() == [True] * k_flush + [False] * (30 - k_flush)
    assert hits[0].tolist() == [True] * k + [False] * (30 - k)
    assert_close(img, ref_img, 1e-5, 1e-6)


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

