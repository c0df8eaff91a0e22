"""Port parity: tile rasterization (K2's plain version) of `repro_torch`
against the JAX package's oracle and Pallas kernel (interpret mode), and the
stereo bit-accuracy property reproduced inside the port."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _raster_cases import raster_cases
from _torch_parity import (CPU, assert_close, assert_equal, np_, saturating_scene,
                           to_torch_gaussians, to_torch_rig, to_torch_splats,
                           to_torch_tile_lists)

from repro.core import binning as jbin
from repro.core import stereo as jst
from repro.core.camera import StereoRig, make_camera
from repro.core.gaussians import Gaussians, random_gaussians
from repro.core.projection import Splats, depth_ranks, project
from repro.kernels import ops as kops
from repro.kernels import ref as kref
from repro.kernels.rasterize import rasterize_slabs_pallas, rasterize_tiles_pallas
from repro.render import batched as jbatched
from repro.render import stages as jstages
from repro.render.config import RenderConfig
from repro.render.stages import render_tiles as j_render_tiles
from repro_torch import kernels as tkernels
from repro_torch import pytree as tpytree
from repro_torch.core import gaussians as tg
from repro_torch.core import pipeline as tpipe
from repro_torch.core.camera import StereoRig as TStereoRig
from repro_torch.core.camera import make_camera as t_make_camera
from repro_torch.kernels import rasterize as traster
from repro_torch.render import batched as tbatched
from repro_torch.render import stages as tstages
from repro_torch.render.config import RenderConfig as TRenderConfig
from repro_torch.render.plan import RenderPlan as TRenderPlan


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



# ---------------------------------------------------------------------------
# the reference's default path (`render_tiles`): α thresholds, no stop, and
# a hit flag for every entry up to the count
# ---------------------------------------------------------------------------


def _as_render_tiles_input(ent, counts, tile):
    """Entry rows as JAX splats (one a row) and one row of tiles whose
    lists name them in order, up to each count: what `render_tiles` takes
    for the tiles of `raster_cases(..., in_a_row=True)`."""
    n, l_len, _ = ent.shape
    flat = ent.reshape(n * l_len, 9)
    zeros = np.zeros(n * l_len, np.float32)
    s = Splats(mean2d=jnp.asarray(flat[:, 0:2]), depth=jnp.asarray(zeros),
               conic=jnp.asarray(flat[:, 2:5]), ext=jnp.zeros((n * l_len, 2), jnp.float32),
               color_l=jnp.asarray(flat[:, 5:8]), color_r=jnp.asarray(flat[:, 5:8]),
               opacity=jnp.asarray(flat[:, 8]), disparity=jnp.asarray(zeros),
               visible=jnp.ones(n * l_len, bool))
    kept = np.clip(counts, 0, l_len)
    idx = np.arange(n * l_len, dtype=np.int32).reshape(n, l_len)
    lists = np.where(np.arange(l_len)[None, :] < kept[:, None], idx, -1).astype(np.int32)
    tl = jbin.TileLists(lists=jnp.asarray(lists), counts=jnp.asarray(kept.astype(np.int32)),
                        overflow=jnp.asarray(False), tiles_x=n, tiles_y=1)
    return s, tl


@pytest.mark.parametrize("l_len", [256, 45])
@pytest.mark.parametrize("eps_t", [0.0, 0.02, 1.0])
@pytest.mark.parametrize("tile", [8, 16, 32])
def test_raster_hits_past_stop_plain_matches_render_tiles(tile, eps_t, l_len):
    """K2's plain version with `hits_past_stop` on `tests/_raster_cases.py`
    against the reference's default path (`render_tiles`, which has no stop
    and no eps_t): hits exact at every eps_t, entries after each designed
    stop (α > 0 right after it) included. At eps_t = 0 the images agree
    within tolerance: XLA's subnormal flush moves only colours."""
    ent, counts, origins, want, _ = raster_cases(tile * 7 + l_len, tile, eps_t, l_len,
                                                 in_a_row=True)
    img, hits = traster.rasterize_slabs_plain(
        torch.from_numpy(ent), torch.from_numpy(counts), torch.from_numpy(origins),
        tile=tile, eps_t=eps_t, hits_past_stop=True)
    s, tl = _as_render_tiles_input(ent, counts, tile)
    n = ent.shape[0]
    ref_img, ref_hits = j_render_tiles(tl, s, width=n * tile, height=tile, tile=tile,
                                       eye="left")
    assert_equal(hits, ref_hits)
    stopped = (want >= 0) & (want < np.clip(counts, 0, l_len))
    assert bool(hits[torch.from_numpy(stopped)].any())    # flags past a stop
    if eps_t == 0.0:
        ref_tiles = np.asarray(ref_img).reshape(tile, n, tile, 3).transpose(1, 0, 2, 3)
        assert_close(img, ref_tiles, 1e-5, 1e-6)
    _, pallas_hits = traster.rasterize_slabs_plain(
        torch.from_numpy(ent), torch.from_numpy(counts), torch.from_numpy(origins),
        tile=tile, eps_t=eps_t)
    assert bool((hits & ~pallas_hits).any()) and not bool((pallas_hits & ~hits).any())


@pytest.fixture(scope="module")
def saturated_plan():
    """The JAX plan of `saturating_scene` (many left tiles stop early)."""
    g = Gaussians(**{k: jnp.asarray(v) for k, v in saturating_scene(60, 1000, 3).items()})
    rig = StereoRig(left=make_camera([33.0, 33.0, 1.7], [40, 40, 1.5], focal_px=200.0,
                                     width=96, height=64, near=0.2), baseline=0.06)
    cfg = RenderConfig.for_rig(rig, tile=16, list_len=256, max_pairs=1 << 16)
    return g, rig, cfg, jstages.build_plan(g, rig, cfg)


def test_render_plan_overflow_matches_jax(saturated_plan):
    """`RenderPlan.overflow`: either eye's budget exceeded, as JAX's."""
    *_rest, plan = saturated_plan
    tplan = _to_torch_plan(plan)
    assert tplan.overflow.dtype == torch.bool and tplan.overflow.shape == ()
    assert bool(tplan.overflow) == bool(plan.overflow)
    assert_equal(tplan.overflow, plan.overflow)


def _to_torch_plan(plan):
    return TRenderPlan(splats=to_torch_splats(plan.splats),
                       ranks=torch.from_numpy(np_(plan.ranks).copy()),
                       left=to_torch_tile_lists(plan.left),
                       right=to_torch_tile_lists(plan.right))


@pytest.mark.parametrize("alpha_min,alpha_max,eps_t,negative", [
    (1 / 255, 0.99, 0.0, False),
    (1 / 255, 0.99, 0.02, False),     # eps_t: ignored, as the default path ignores it
    (0.05, 0.5, 0.0, False),
    (1 / 255, 1.0, 0.02, False),
    (1 / 255, 1.5, 0.0, False),       # alpha_max > 1: no stop
    (-0.1, 0.99, 0.0, True),          # α < 0 from negative opacities: no stop
], ids=["default", "eps_t", "override", "alpha_max_1", "alpha_max_1.5", "negative"])
def test_stage_matches_render_tiles(saturated_plan, alpha_min, alpha_max, eps_t, negative):
    """The port's raster stage (the session's and the vmapped fleet's)
    against the JAX stage's default path on the same plan, where tiles
    saturate: hits exact, images within the session's tolerance, under α
    overrides, eps_t > 0 and thresholds that disable the early stop."""
    _g, _rig, cfg, plan = saturated_plan
    if negative:
        opa = np.asarray(plan.splats.opacity).copy()
        opa[::7] = -0.05
        plan = dataclasses.replace(plan, splats=dataclasses.replace(
            plan.splats, opacity=jnp.asarray(opa)))
    cfg = dataclasses.replace(cfg, alpha_min=alpha_min, alpha_max=alpha_max, eps_t=eps_t)
    tcfg = TRenderConfig(**dataclasses.asdict(cfg))
    tplan = _to_torch_plan(plan)
    il, ir, hits = tstages.rasterize(tplan, tcfg)
    jl, jr, jhits = jstages.rasterize(plan, cfg)
    assert_equal(hits, jhits)
    assert_close(il, jl, 1e-4, 1e-5)
    assert_close(ir, jr, 1e-4, 1e-5)
    assert bool(hits.any()) and float(il.max()) > 0
    ent, counts = traster.gather_entries(tplan.left, tplan.splats, "left")
    origins = traster.tile_origins(ent.shape[0], tplan.left.tiles_x, cfg.tile, CPU)
    _, p_hits, done = traster.rasterize_slabs_plain(
        ent, counts, origins, tile=cfg.tile, eps_t=eps_t, alpha_min=alpha_min,
        alpha_max=alpha_max, with_processed=True)
    stops = bool((done < counts.clamp(0, ent.shape[1])).any())
    if traster.stop_allowed(alpha_min, alpha_max):
        assert stops or alpha_max < 0.9      # at alpha_max 0.5 no tile saturates
    else:
        assert not stops
    assert stops == bool((hits != p_hits).any())   # the Pallas contract's flags differ


def test_pooled_alpha_thresholds_are_a_fault_of_the_reference(saturated_plan):
    """JAX's pooled fleet render calls the Pallas raster without `cfg`'s α
    thresholds (`src/repro/render/batched.py:214`), so under an override
    its frames are those of the default thresholds, not the vmap path's.
    The port's pooled render honours them: its frames equal its vmap
    path's bit for bit and the JAX vmap path's within tolerance."""
    g, rig, cfg, _plan = saturated_plan
    cfg = dataclasses.replace(cfg, list_len=64, alpha_min=0.05, alpha_max=0.5)
    queues = jbatched.stack_pytrees([g])
    rigs = jbatched.stack_rigs([rig])
    jp_l, jp_r, _ = jbatched.batched_render_stereo(queues, rigs, cfg, path="pooled")
    jv_l, jv_r, _ = jbatched.batched_render_stereo(queues, rigs, cfg, path="vmap")
    jd_l, _, _ = jbatched.batched_render_stereo(
        queues, rigs, dataclasses.replace(cfg, alpha_min=1 / 255, alpha_max=0.99),
        path="vmap")
    assert float(np.abs(np.asarray(jp_l) - np.asarray(jv_l)).max()) > 0.01
    assert_close(torch.from_numpy(np.asarray(jp_l).copy()), jd_l, 1e-4, 1e-5)
    tcfg = TRenderConfig(**dataclasses.asdict(cfg))
    tq = tpytree.stack([to_torch_gaussians(g)])
    trig = tbatched.stack_rigs([to_torch_rig(rig)])
    tp_l, tp_r, _ = tbatched.batched_render_stereo(tq, trig, tcfg, path="pooled")
    tv_l, tv_r, _ = tbatched.batched_render_stereo(tq, trig, tcfg, path="vmap")
    assert_equal(tp_l, tv_l)
    assert_equal(tp_r, tv_r)
    assert_close(tp_l, jv_l, 1e-4, 1e-5)
    assert_close(tp_r, jv_r, 1e-4, 1e-5)
