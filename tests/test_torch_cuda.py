"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device (marker `cuda`) and skips without one.
The file imports nothing of JAX, so it also runs on a machine that has only
PyTorch:

    PYTHONPATH=src:tests python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from _merge_cases import merge_sources
from _raster_cases import raster_cases
from _torch_parity import saturating_scene
from _vq_cases import DIMS, vq_cases
from repro_torch import convert, pytree
from repro_torch import kernels as K
from repro_torch import render as R
from repro_torch.core import binning as TB
from repro_torch.core import camera as C
from repro_torch.core import gaussians as G
from repro_torch.core import lod_search as LS
from repro_torch.core import pipeline as P
from repro_torch.core.lod_tree import build_lod_tree
from repro_torch.core.stereo import build_merge_sources
from repro_torch.configs import get_arch
from repro_torch.kernels import (binning, flash_attention, lod_cut, preprocess, rasterize,
                                 stereo_shift, vq_assign)
from repro_torch.models import dense, model_zoo
from repro_torch.models.config import reduced
from repro_torch.serve.lod_service import LodService

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(dev):
    leaves = G.generate_city(G.CityConfig(blocks_x=2, blocks_y=2, leaf_density=0.3,
                                          seed=1), device=dev)
    tree = build_lod_tree(leaves, target_subtrees=16, seed=0, device=dev)
    rig = C.StereoRig(left=C.make_camera([30, 30, 1.7], [60, 60, 1.5], focal_px=400.0,
                                         width=256, height=192, near=0.2, device=dev))
    return tree, rig


def test_k1_lod_sweep(scene):
    tree, rig = scene
    cam = rig.left.pos
    top_expand, _ = LS.top_sweep(tree, cam, 400.0, 16.0)
    rpe = LS._root_parent_expand(tree, top_expand)
    args = (tree.slab_mu(), tree.slab_size(), tree.slab_parent, tree.slab_level,
            tree.slab_is_leaf, tree.slab_valid, rpe, cam, 400.0, 16.0)
    before = lod_cut.lod_slab_sweep.launches
    k = lod_cut.lod_slab_sweep(*args, max_depth=tree.meta.slab_max_depth)
    p = lod_cut.slab_sweep_plain(*args, max_depth=tree.meta.slab_max_depth)
    torch.cuda.synchronize()
    assert lod_cut.lod_slab_sweep.launches == before + 1
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    assert torch.allclose(k[2], p[2], rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("sh_degree", [0, 1, 2])
def test_k3_preprocess(dev, scene, sh_degree):
    _, rig = scene
    g = G.random_gaussians(np.random.default_rng(sh_degree), 3000, sh_degree=sh_degree,
                           extent=40.0, device=dev)
    g = dataclasses.replace(g, mu=g.mu + torch.tensor([45.0, 45.0, 0.0], device=dev))
    wide = dataclasses.replace(rig.left, width=rig.left.width + 96)
    k = preprocess.preprocess(g, rig, wide)
    p = preprocess.preprocess_plain(g, rig, wide)
    torch.cuda.synchronize()
    for f in ("mean2d", "depth", "conic", "ext", "color_l", "color_r", "opacity",
              "disparity"):
        assert torch.allclose(getattr(k, f), getattr(p, f), rtol=2e-5, atol=2e-5,
                              equal_nan=True), f
    assert torch.equal(k.visible, p.visible) and bool(k.visible.any())


def _plan(tree, rig):
    cut, _ = LS.full_search(tree, rig.left.pos, 400.0, 16.0)
    gids = LS.compact_ids(cut.mask(tree), 4096)
    q = P._render_queue(tree.gaussians, gids)
    cfg = R.RenderConfig.for_rig(rig, list_len=64, max_pairs=1 << 18)
    return R.build_plan(q, rig, cfg), cfg


# K4: the session's own sources, and adversarial ones (ties across rows,
# repeats inside a row, all-INF tiles, count < L, = L, > L) at every n_cat
# the rigs give up to the VR rig at tile 8 (44)
@pytest.mark.parametrize("case", ["scene"] + [(n_cat, l_len) for n_cat in (1, 23, 33, 44)
                                              for l_len in (1, 7, 256)])
def test_k4_stereo_merge(dev, scene, case):
    if case == "scene":
        tree, rig = scene
        plan, cfg = _plan(tree, rig)
        src_r, src_i = build_merge_sources(plan.left, plan.splats, plan.ranks,
                                           tile=cfg.tile, width=cfg.width, n_cat=cfg.n_cat)
    else:
        r, i = merge_sources(case[0] * 1000 + case[1], *case)
        src_r, src_i = torch.from_numpy(r).to(dev), torch.from_numpy(i).to(dev)
    before = stereo_shift.stereo_merge_kernel.launches
    k = stereo_shift.stereo_merge_kernel(src_r, src_i)
    p = stereo_shift.stereo_merge_plain(src_r, src_i)
    torch.cuda.synchronize()
    assert stereo_shift.stereo_merge_kernel.launches == before + 1
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert int(k[1].sum()) > 0


def _splat_field(dev, seed, m, width, height, ext_px):
    """m splats over a width×height image: means up to 100 px past its
    edges, extents up to ext_px, a conic whose 3σ box is the extent with a
    random tilt, opacities from 0.01, 9 in 10 visible, a random depth order."""
    rng = np.random.default_rng(seed)
    mean = np.stack([rng.uniform(-100, width + 100, m), rng.uniform(-100, height + 100, m)], 1)
    ext = rng.uniform(0.5, ext_px, (m, 2))
    sig = ext / 3
    conic = np.stack([1 / sig[:, 0] ** 2, rng.uniform(-0.3, 0.3, m) / (sig[:, 0] * sig[:, 1]),
                      1 / sig[:, 1] ** 2], 1)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, device=dev).to(dtype)
    return dict(mean2d=t(mean), ext=t(ext), conic=t(conic), opacity=t(rng.uniform(0.01, 1, m)),
                visible=t(rng.random(m) < 0.9, torch.bool),
                ranks=t(rng.permutation(m), torch.int32))


# The binning chain: the session's splats at a budget that holds them and at
# one a third of their need (index-order truncation), list overflows, no
# splats, none visible, tied ranks, no precise cull, the right eye's grid,
# splats spanning hundreds of tiles, and grids whose tile ids take 16 bits
# (65536 tiles) and 17 (78250: the 32-bit key).
BIN_CASES = ["scene", "pair_budget", ("list_len", 1), ("list_len", 7), ("list_len", 256),
             "no_splats", "none_visible", "tied_ranks", "no_cull", "right_eye",
             "wide_splats", "grid_65536", "grid_78250"]


@pytest.mark.parametrize("case", BIN_CASES)
def test_bin_tiles_kernel_matches_plain(dev, scene, case):
    """`bin_tiles` on the card (the chain) against `bin_tiles_plain` on the
    same CUDA inputs: lists, counts and the overflow flag exact, the
    wrapper's launches counted, two runs bit-identical."""
    cfg = TB.BinConfig(tile=16, max_pairs=1 << 18, list_len=64)
    synthetic = {"wide_splats": (0, 400, 1024, 768, 600.0),
                 "grid_65536": (1, 20000, 4096, 4096, 60.0),
                 "grid_78250": (2, 20000, 5008, 4000, 60.0)}
    if case in synthetic:
        seed, m, width, height, ext_px = synthetic[case]
        f = _splat_field(dev, seed, m, width, height, ext_px)
        mean2d, ext, ranks, vis = f["mean2d"], f["ext"], f["ranks"], f["visible"]
        conic, opacity = f["conic"], f["opacity"]
        cfg = dataclasses.replace(cfg, max_pairs=1 << 21)
    else:
        tree, rig = scene
        plan, rcfg = _plan(tree, rig)
        s, ranks = plan.splats, plan.ranks
        mean2d, ext, vis, conic, opacity = s.mean2d, s.ext, s.visible, s.conic, s.opacity
        width, height = rcfg.wide_width, rcfg.height
    _, _, span_w, span_h = TB.pair_spans(mean2d, ext, vis, width, height, cfg.tile)
    need = int((span_w * span_h).sum())
    if case == "pair_budget":
        cfg = dataclasses.replace(cfg, max_pairs=need // 3 + 5)
    elif isinstance(case, tuple):
        cfg = dataclasses.replace(cfg, list_len=case[1])
    elif case == "no_splats":
        mean2d, ext, ranks, vis = mean2d[:0], ext[:0], ranks[:0], vis[:0]
        conic, opacity = conic[:0], opacity[:0]
    elif case == "none_visible":
        vis = torch.zeros_like(vis)
    elif case == "tied_ranks":
        ranks = ranks // 3
    elif case == "no_cull":
        conic = opacity = None
    elif case == "right_eye":
        mean2d = s.mean2d - torch.stack([s.disparity, torch.zeros_like(s.disparity)], -1)
        width = rcfg.width
    args = (mean2d, ext, ranks, vis, width, height, cfg)
    before = binning.bin_tiles_kernel.launches
    if case == "right_eye":
        got = [TB.bin_right(s, width, height, cfg, ranks) for _ in range(2)]
    else:
        got = [TB.bin_tiles(*args, conic=conic, opacity=opacity) for _ in range(2)]
    want = TB.bin_tiles_plain(*args, conic=conic, opacity=opacity)
    torch.cuda.synchronize()
    assert binning.bin_tiles_kernel.launches == before + 2
    for g in got:
        assert torch.equal(g.lists, want.lists) and g.lists.dtype == torch.int32
        assert torch.equal(g.counts, want.counts) and g.counts.dtype == torch.int32
        assert g.overflow.shape == () and bool(g.overflow) == bool(want.overflow)
        assert (g.tiles_x, g.tiles_y) == (want.tiles_x, want.tiles_y)
    assert torch.equal(got[0].lists, got[1].lists) and torch.equal(got[0].counts, got[1].counts)
    kept = int(want.counts.sum())
    assert (kept == 0) == (case in ("no_splats", "none_visible"))
    if case == "pair_budget":
        assert need > cfg.max_pairs and bool(want.overflow)
    if case == ("list_len", 1):
        assert bool(want.overflow)
    if case == "wide_splats":
        assert int((span_w * span_h).max()) >= 300
    if case in ("grid_65536", "grid_78250"):
        assert binning.wide_key(want.tiles_x * want.tiles_y) == (case == "grid_78250")


def test_k2_raster(scene):
    tree, rig = scene
    plan, cfg = _plan(tree, rig)
    for lists, eye in ((plan.left, "left"), (plan.right, "right")):
        ent, counts = rasterize.gather_entries(lists, plan.splats, eye)
        origins = rasterize.tile_origins(ent.shape[0], lists.tiles_x, cfg.tile, ent.device)
        counts = counts.contiguous()
        k = rasterize.rasterize_slabs(ent, counts, origins, tile=cfg.tile)
        p = rasterize.rasterize_slabs_plain(ent, counts, origins, tile=cfg.tile)
        torch.cuda.synchronize()
        assert torch.allclose(k[0], p[0], rtol=1e-5, atol=1e-6)
        assert torch.equal(k[1], p[1]) and float(k[0].max()) > 0


# K2 on adversarial tiles (tests/_raster_cases.py): stops before, at and
# after each edge of a window of 8, 16 and 32 entries with an entry of
# α > 0 right after, count 0, -1, L and L + 5, NaN/inf conics and opacities
@pytest.mark.parametrize("l_len", [256, 45])
@pytest.mark.parametrize("eps_t", [0.0, 0.02, 1.0])
@pytest.mark.parametrize("tile", [8, 16, 24, 32])
def test_k2_raster_adversarial(dev, tile, eps_t, l_len):
    ent, counts, origins, want, _ = raster_cases(tile * 7 + l_len, tile, eps_t, l_len)
    ent, counts, origins = (torch.from_numpy(x).to(dev) for x in (ent, counts, origins))
    p_img, p_hits, done = rasterize.rasterize_slabs_plain(
        ent, counts, origins, tile=tile, eps_t=eps_t, with_processed=True)
    designed = torch.from_numpy(want >= 0).to(dev)
    assert torch.equal(done[designed], torch.from_numpy(want).to(dev)[designed])
    before = rasterize.rasterize_slabs.launches
    img, hits = rasterize.rasterize_slabs(ent, counts, origins, tile=tile, eps_t=eps_t)
    torch.cuda.synchronize()
    assert rasterize.rasterize_slabs.launches == before + 1
    assert torch.equal(hits, p_hits), int((hits != p_hits).sum())
    assert torch.allclose(img, p_img, rtol=1e-5, atol=1e-6)


def test_k2_raster_rejects_what_it_cannot_take(dev):
    ent = torch.zeros((2, 8, 9), device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    origins = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="pixels"):
        rasterize.rasterize_slabs(ent, counts, origins, tile=12)


# K2 under the reference's default-path contract (`hits_past_stop`: flags
# after a stop) and under α thresholds other than the defaults, some of
# which disable the stop (α > 1, or α < 0 from negative opacities, or
# alpha_max < 0, under which the rows padding a window must stay no-ops),
# or let no α pass
THRESHOLDS = [(0.05, 0.5), (1 / 255, 1.5), (-0.1, 0.99), (-0.5, -0.1), (0.5, 0.1)]


@pytest.mark.parametrize("l_len", [256, 45])
@pytest.mark.parametrize("eps_t", [0.0, 0.02, 1.0])
@pytest.mark.parametrize("tile", [8, 16, 24, 32])
def test_k2_raster_adversarial_hits_past_stop(dev, tile, eps_t, l_len):
    ent, counts, origins, _, _ = raster_cases(tile * 7 + l_len, tile, eps_t, l_len)
    ent, counts, origins = (torch.from_numpy(x).to(dev) for x in (ent, counts, origins))
    p_img, p_hits = rasterize.rasterize_slabs_plain(ent, counts, origins, tile=tile,
                                                    eps_t=eps_t, hits_past_stop=True)
    img, hits = rasterize.rasterize_slabs(ent, counts, origins, tile=tile, eps_t=eps_t,
                                          hits_past_stop=True)
    torch.cuda.synchronize()
    assert torch.equal(hits, p_hits), int((hits != p_hits).sum())
    assert torch.allclose(img, p_img, rtol=1e-5, atol=1e-6)
    _, pallas = rasterize.rasterize_slabs(ent, counts, origins, tile=tile, eps_t=eps_t)
    assert not bool((pallas & ~hits).any())
    if 1.0 > eps_t:
        assert bool((hits & ~pallas).any())


@pytest.mark.parametrize("hits_past_stop", [False, True])
@pytest.mark.parametrize("alpha_min,alpha_max", THRESHOLDS)
@pytest.mark.parametrize("tile", [8, 16])
def test_k2_raster_alpha_thresholds(dev, tile, alpha_min, alpha_max, hits_past_stop):
    ent, counts, origins, _, _ = raster_cases(tile + 3, tile, 0.02, 45)
    ent[1::5, :, 8] = -0.05            # negative opacities: α < 0 where alpha_min ≤ 0
    ent, counts, origins = (torch.from_numpy(x).to(dev) for x in (ent, counts, origins))
    kw = dict(tile=tile, eps_t=0.02, alpha_min=alpha_min, alpha_max=alpha_max,
              hits_past_stop=hits_past_stop)
    p_img, p_hits = rasterize.rasterize_slabs_plain(ent, counts, origins, **kw)
    img, hits = rasterize.rasterize_slabs(ent, counts, origins, **kw)
    torch.cuda.synchronize()
    assert torch.equal(hits, p_hits), int((hits != p_hits).sum())
    fin = torch.isfinite(p_img)
    assert torch.equal(fin, torch.isfinite(img))
    assert torch.allclose(img[fin], p_img[fin], rtol=1e-5, atol=1e-6)


def test_k2_stage_default_path_on_saturated_tiles(dev):
    """The raster stage on the card (left eye with hits past the stop)
    against the same stage on the CPU (the plain version), where tiles
    saturate; and the flags it adds over the Pallas contract."""
    g = convert.gaussians_from_arrays(saturating_scene(60, 1000, 3), dev)
    rig = C.StereoRig(left=C.make_camera([33.0, 33.0, 1.7], [40, 40, 1.5], focal_px=200.0,
                                         width=96, height=64, near=0.2, device=dev),
                      baseline=0.06)
    cfg = R.RenderConfig.for_rig(rig, list_len=256, max_pairs=1 << 16)
    plan = R.build_plan(g, rig, cfg)
    il, ir, hits = R.rasterize(plan, cfg)
    pl, pr, phits = R.rasterize(pytree.tree_map(lambda t: t.cpu(), plan), cfg)
    torch.cuda.synchronize()
    assert torch.equal(hits.cpu(), phits)
    assert torch.allclose(il.cpu(), pl, rtol=1e-5, atol=1e-6)
    assert torch.allclose(ir.cpu(), pr, rtol=1e-5, atol=1e-6)
    ent, counts = rasterize.gather_entries(plan.left, plan.splats, "left")
    origins = rasterize.tile_origins(ent.shape[0], plan.left.tiles_x, cfg.tile, dev)
    _, pallas = rasterize.rasterize_slabs(ent, counts.contiguous(), origins, tile=cfg.tile)
    assert bool((hits & ~pallas).any()) and not bool((pallas & ~hits).any())


def _k3_queue(dev, m, k, seed):
    """m random Gaussians around the scene's camera, some behind it."""
    g = G.random_gaussians(np.random.default_rng(seed), m, sh_degree={1: 0, 4: 1, 9: 2}[k],
                           extent=40.0, device=dev)
    return dataclasses.replace(g, mu=g.mu + torch.tensor([30.0, 30.0, 0.0], device=dev))


def _k3_check(g, rig):
    wide = dataclasses.replace(rig.left, width=rig.left.width + 96)
    before = preprocess.preprocess.launches
    k = preprocess.preprocess(g, rig, wide)
    p = preprocess.preprocess_plain(g, rig, wide)
    torch.cuda.synchronize()
    assert preprocess.preprocess.launches == before + 1
    for f in ("mean2d", "depth", "conic", "ext", "color_l", "color_r", "opacity",
              "disparity"):
        assert torch.allclose(getattr(k, f), getattr(p, f), rtol=2e-5, atol=2e-5,
                              equal_nan=True), f
    assert torch.equal(k.visible, p.visible)
    return k, p


# K3 around its 256-row blocks (a tail of 1, 255, 0 and 1 rows, and more
# blocks than the card has SMs), for every SH size; rows behind the camera
@pytest.mark.parametrize("m", [1, 255, 256, 257, 3000, 65537])
@pytest.mark.parametrize("k", [1, 4, 9])
def test_k3_preprocess_tails(dev, scene, m, k):
    _, rig = scene
    g = _k3_queue(dev, m, k, seed=m + k)
    kk, p = _k3_check(g, rig)
    if m >= 3000:
        assert bool(p.visible.any()) and bool((p.depth < 0).any())


def test_k3_preprocess_unaligned_rows(dev, scene):
    """Arrays whose start is not 16-byte aligned (a view from row 1): the
    kernel stages them with 4-byte copies."""
    _, rig = scene
    g = _k3_queue(dev, 1001, 4, seed=5)
    g1 = g[1:]
    assert g1.mu.data_ptr() % 16 != 0
    _k3_check(g1, rig)


@pytest.mark.parametrize("baseline", [0.1, 1.5])
def test_k3_preprocess_rig_baseline(dev, scene, baseline):
    """The kernel reads the right eye where StereoRig.right puts it, at a
    baseline other than the default (the right eye's colors tell)."""
    _, rig = scene
    rig_b = dataclasses.replace(rig, baseline=baseline)
    g = _k3_queue(dev, 3000, 4, seed=7)
    k, _ = _k3_check(g, rig_b)
    assert not torch.allclose(k.color_l, k.color_r)


def test_k2_k3_make_no_synchronizing_call(dev, scene):
    """On the card neither wrapper waits on the stream: both run under
    torch.cuda.set_sync_debug_mode("error")."""
    tree, rig = scene
    plan, cfg = _plan(tree, rig)
    g = _k3_queue(dev, 3000, 4, seed=0)
    wide = dataclasses.replace(rig.left, width=rig.left.width + 96)
    ent, counts = rasterize.gather_entries(plan.left, plan.splats, "left")
    origins = rasterize.tile_origins(ent.shape[0], plan.left.tiles_x, cfg.tile, dev)
    counts = counts.contiguous()
    preprocess.preprocess(g, rig, wide)                  # build the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s = preprocess.preprocess(g, rig, wide)
        img, hits = rasterize.rasterize_slabs(ent, counts, origins, tile=cfg.tile)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert bool(s.visible.any()) and float(img.max()) > 0


def test_session_launches_every_kernel(scene):
    tree, rig = scene
    cfg = P.SessionConfig(tau=16.0, w=2, cut_budget=4096, list_len=64, max_pairs=1 << 18,
                          use_compression=False)
    sess = P.CollaborativeSession(tree, cfg, rig)
    K.reset_launch_counts()
    for i in range(4):
        shifted = C.StereoRig(left=rig.left.translated(
            torch.tensor([0.3 * i, 0.0, 0.0], device=rig.left.pos.device)))
        st, (il, ir, _) = sess.step(shifted, render=True)
        assert torch.isfinite(il).all() and float(il.max()) > 0
    counts = K.launch_counts()
    assert counts == {"lod_slab_sweep": 2, "preprocess": 4, "stereo_merge": 4,
                      "rasterize_slabs": 8, "vq_assign": 0, "lod_pair_sweep": 0,
                      "flash_attention": 0, "flash_attention_backward": 0,
                      "bin_tiles": 4}, counts


@pytest.mark.parametrize("d", [9, 24, 45])
def test_k5_vq_assign(dev, d):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(20000, d)).astype(np.float32)
    cb = rng.normal(size=(256, d)).astype(np.float32)
    cb[200] = cb[17]                     # an exact tie across the 128-blocks
    x[:5] = cb[17] + 1e-3
    x[5] = np.nan                        # NaN scores: torch.argmin's answer
    xt, ct = torch.from_numpy(x).to(dev), torch.from_numpy(cb).to(dev)
    before = vq_assign.vq_assign.launches
    k = vq_assign.vq_assign(xt, ct)
    p = vq_assign.vq_assign_plain(xt, ct)
    torch.cuda.synchronize()
    assert vq_assign.vq_assign.launches == before + 1
    assert torch.equal(k, p)
    assert k[:5].tolist() == [17] * 5


# K5 (tensor-core filter, exact rescoring) on tests/_vq_cases.py: equal
# codewords, codewords 1 ulp apart, dyadic midpoints, 1e18 and overflowing
# scores, subnormals, NaN/inf rows and codewords, Kc 1/7/255/256, M 0/1/65
@pytest.mark.parametrize("d", DIMS)
def test_k5_vq_cases(dev, d):
    for c in vq_cases(d):
        xt, ct = torch.from_numpy(c.x).to(dev), torch.from_numpy(c.codebook).to(dev)
        vq_assign.reset_filter_counts(dev)
        k = vq_assign.vq_assign(xt, ct)
        p = vq_assign.vq_assign_plain(xt, ct)
        n = vq_assign.filter_counts(dev)
        assert torch.equal(k, p), (c.name, int((k != p).sum()))
        m, scanned = c.x.shape[0], c.scanned_rows()
        assert (n["scanned"], n["filtered"]) == (scanned, m - scanned), (c.name, n)
        assert n["candidates"] >= n["filtered"], (c.name, n)


def test_k5_scan_kernel_and_unaligned_rows(dev):
    """A codebook too large for the filter's shared memory (Kc 1200 at
    D = 45) takes the scan kernel; rows that start off a 16-byte boundary
    take the filter's 4-byte copies."""
    rng = np.random.default_rng(5)
    cb = torch.from_numpy(rng.normal(size=(1200, 45)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(3001, 45)).astype(np.float32)).to(dev)
    vq_assign.reset_filter_counts(dev)
    assert torch.equal(vq_assign.vq_assign(x, cb), vq_assign.vq_assign_plain(x, cb))
    assert vq_assign.filter_counts(dev)["scanned"] == 3001
    x9 = torch.from_numpy(rng.normal(size=(3001 * 9 + 1,)).astype(np.float32)).to(dev)
    x9 = x9[1:].view(3001, 9)
    cb9 = torch.from_numpy(rng.normal(size=(256, 9)).astype(np.float32)).to(dev)
    assert x9.data_ptr() % 16 != 0
    vq_assign.reset_filter_counts(dev)
    assert torch.equal(vq_assign.vq_assign(x9, cb9), vq_assign.vq_assign_plain(x9, cb9))
    n = vq_assign.filter_counts(dev)
    assert n["filtered"] == 3001 and n["scanned"] == 0
    assert n["candidates"] < 2 * 3001, n


def test_k6_pair_sweep(scene):
    tree, rig = scene
    m = tree.meta
    g = torch.Generator().manual_seed(0)
    k = 3 * m.Ns
    sel = torch.randint(0, m.Ns, (k,), generator=g).to(tree.device)
    cams = (rig.left.pos[None, :] + 20.0 * torch.randn(k, 3, generator=g).to(tree.device))
    taus = torch.tensor([8.0, 16.0, 48.0], device=tree.device)[torch.arange(k) % 3]
    rpe = (torch.rand(k, generator=g) < 0.8).to(tree.device)
    args = (tree.slab_mu()[sel], tree.slab_size()[sel], tree.slab_parent[sel],
            tree.slab_level[sel], tree.slab_is_leaf[sel], tree.slab_valid[sel], rpe,
            cams.contiguous(), 400.0, taus.contiguous())
    before = lod_cut.lod_pair_sweep.launches
    kk = lod_cut.lod_pair_sweep(*args, max_depth=m.slab_max_depth)
    pp = lod_cut.pair_sweep_plain(*args, max_depth=m.slab_max_depth)
    torch.cuda.synchronize()
    assert lod_cut.lod_pair_sweep.launches == before + 1
    for a, b in zip(kk, pp):
        assert torch.equal(a, b)
    assert bool(kk[0].any())


def test_fleet_pooled_matches_vmapped_and_launches(scene):
    """A 3-client fleet on the card: the pooled sync (K6 + K5) equals the
    vmapped one (K1 per client), and the pooled fallback render (one K2
    launch) equals the per-client render (two K2 launches per client)."""
    tree, rig = scene
    cfg = P.SessionConfig(tau=16.0, cut_budget=4096)
    taus = [16.0, 28.0, 16.0]
    pooled = LodService(tree, cfg, 3, focal=400.0, mode="pooled", taus=taus)
    vmapped = LodService(tree, cfg, 3, focal=400.0, mode="vmapped", taus=taus)
    vmapped.codec = pooled.codec
    base = rig.left.pos.cpu().numpy()
    K.reset_launch_counts()
    for i in range(3):
        cams = np.stack([base + [0.4 * i * c, 0.0, 0.0] for c in range(3)])
        a, b = pooled.sync(cams), vmapped.sync(cams)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
        assert torch.equal(pooled.state.cut_gids, vmapped.state.cut_gids)
    counts = K.launch_counts()
    assert counts["lod_pair_sweep"] >= 1 and counts["vq_assign"] >= 6, counts
    assert counts["lod_slab_sweep"] == 9, counts
    rigs = [C.StereoRig(left=rig.left.translated(
        torch.tensor([0.4 * c, 0.0, 0.0], device=rig.left.pos.device)))
        for c in range(3)]
    K.reset_launch_counts()
    pl, pr, ps = pooled.render_fallback(rigs, list_len=64, max_pairs=1 << 18,
                                        path="pooled")
    assert K.launch_counts()["rasterize_slabs"] == 1
    vl, vr, vs = pooled.render_fallback(rigs, list_len=64, max_pairs=1 << 18, path="vmap")
    torch.cuda.synchronize()
    assert torch.equal(pl, vl) and torch.equal(pr, vr) and float(pl.max()) > 0
    for f in dataclasses.fields(ps):
        assert torch.equal(getattr(ps, f.name), getattr(vs, f.name)), f.name


def _churn_script(svc, base, rng_seed=0, ops=None):
    """A ragged-fleet script: syncs at moving cameras, a growing admit, an
    evict and a recycled slot, a NACK of one page, a partial sync and a
    shrink, each call made through `ops` (the service itself, or a
    `RecoveryManager` over it). Returns each sync's stats and cut ids, and
    the checksums of each sync's pages, all on the host."""
    ops = svc if ops is None else ops
    rng = np.random.default_rng(rng_seed)
    out = []

    def sync(cams=None, participate=None):
        st = ops.sync(cams, participate=participate)
        out.append(({f.name: getattr(st, f.name).cpu().numpy()
                     for f in dataclasses.fields(st)},
                    svc.state.cut_gids.cpu().numpy(), svc.delta_checksums()))

    def moved():
        return {c: base + rng.normal(0, 4.0, 3).astype(np.float32) for c in svc.active_ids}

    sync(moved())
    ops.admit(base + 2.0, bandwidth="phone")          # capacity 2 -> 4
    sync(moved())
    ops.evict(0)
    ops.admit(base - 1.0, tau=24.0)                   # into the recycled slot 0
    sync(moved())
    # client 3's first (cold) sync: drop the first page it took rows from
    rows = svc.last_delta.row_page.cpu().numpy()
    took = rows[svc.last_delta.ref_mask[svc._slot_of(3)].cpu().numpy() & (rows >= 0)]
    assert took.size and ops.nack(3, np.unique(took)[:1]) > 0
    sync(moved())
    sync(moved(), participate=svc.active_ids[:2])
    ops.evict(1)
    assert ops.maybe_shrink() == 2
    sync(moved())
    return out


def test_ragged_fleet_on_card_matches_cpu(scene):
    """A churned pooled service on the card (K6, K5) against the same script
    run by the port on the CPU (plain versions): every stats column equal
    (ids and counts exactly, `sync_bytes` bit for bit), the cut ids equal,
    and the page checksums of each card-built payload equal the CPU's."""
    tree, rig = scene
    cfg = P.SessionConfig(tau=16.0, cut_budget=4096)
    kw = dict(focal=400.0, mode="pooled", bandwidth=[2e4, None], page_size=64)
    card = LodService(tree, cfg, 2, **kw)
    host = LodService(tree.to("cpu"), cfg, 2, device="cpu", **kw)
    host.codec = pytree.tree_map(lambda x: x.cpu(), card.codec)
    base = rig.left.pos.cpu().numpy()
    K.reset_launch_counts()
    got = _churn_script(card, base)
    counts = K.launch_counts()
    want = _churn_script(host, base)
    assert counts["lod_pair_sweep"] >= 1 and counts["vq_assign"] >= len(got), counts
    for k, ((gs, gc, gk), (ws, wc, wk)) in enumerate(zip(got, want)):
        for name, arr in ws.items():
            assert gs[name].dtype == arr.dtype, name
            np.testing.assert_array_equal(gs[name], arr, err_msg=f"sync {k}: {name}")
        np.testing.assert_array_equal(gc, wc, err_msg=f"sync {k}: cut ids")
        assert gk.dtype == np.uint32
        np.testing.assert_array_equal(gk, wk, err_msg=f"sync {k}: checksums")
    assert card.active_ids == host.active_ids and card.capacity == 2


def test_ragged_pooled_render_masks_free_slots(scene):
    """A fleet of 4 slots with 2 free (an evicted one and one from growth):
    the pooled render is one K2 launch, the free slots' frames are black and
    the frames equal the per-client render on the card bit for bit."""
    tree, rig = scene
    cfg = P.SessionConfig(tau=16.0, cut_budget=4096)
    svc = LodService(tree, cfg, 2, focal=400.0, mode="pooled")
    base = rig.left.pos.cpu().numpy()
    svc.admit(base + [0.8, 0.0, 0.0])                  # capacity 2 -> 4
    svc.evict(1)
    svc.sync({c: base + [0.4 * c, 0.0, 0.0] for c in svc.active_ids})
    assert svc.capacity == 4 and svc.active_ids == [0, 2]
    rigs = [C.StereoRig(left=rig.left.translated(
        torch.tensor([0.4 * c, 0.0, 0.0], device=rig.left.pos.device)))
        for c in svc.active_ids]
    K.reset_launch_counts()
    pl, pr, ps = svc.render_fallback(rigs, list_len=64, max_pairs=1 << 18, path="pooled")
    assert K.launch_counts()["rasterize_slabs"] == 1
    vl, vr, vs = svc.render_fallback(rigs, list_len=64, max_pairs=1 << 18, path="vmap")
    torch.cuda.synchronize()
    free = torch.as_tensor(~svc._active, device=pl.device)
    assert not pl[free].any() and not pr[free].any() and float(pl.max()) > 0
    assert torch.equal(pl, vl) and torch.equal(pr, vr)
    # the pooled launch keeps the Pallas contract (no flag past a stop)
    for f in dataclasses.fields(ps):
        a, b = getattr(ps, f.name), getattr(vs, f.name)
        assert bool((a >= b).all()) if f.name == "right_alpha_skipped" else torch.equal(a, b), \
            f.name
        assert not a[free].any(), f.name


def _service_arrays(svc) -> dict:
    """Every `ServiceState` leaf, every host mirror and the controller's
    carried bytes of a service, on the host."""
    out = {key: leaf.cpu().numpy() for key, leaf in pytree.flatten_with_paths(svc.state)}
    for name in ("_active", "_client_ids", "_slot_cams", "_delta_ids", "_bw_target",
                 "_allowance", "_tau_scale", "_stats_fresh"):
        out[name] = np.asarray(getattr(svc, name))
    out["next_id"] = np.asarray(svc._next_id)
    if svc._last_stats is not None:
        out["last_sync_bytes"] = svc._last_stats.sync_bytes.cpu().numpy()
    return out


def _assert_same_service(got, want, ctx):
    a, b = _service_arrays(got), _service_arrays(want)
    assert a.keys() == b.keys(), ctx
    for key in b:
        assert a[key].dtype == b[key].dtype, f"{ctx}: {key}"
        np.testing.assert_array_equal(a[key], b[key], err_msg=f"{ctx}: {key}")


def _on(svc, device_type):
    return all(leaf.device.type == device_type
               for _key, leaf in pytree.flatten_with_paths(svc.state)) and (
        svc._last_stats is None or svc._last_stats.sync_bytes.device.type == device_type)


def test_recovery_on_card_matches_cpu(scene, tmp_path):
    """The churn script journaled through a `RecoveryManager` on the card,
    then a crash and `recover` on the card (K6 and K5 in the replay),
    against the same script on the CPU port: every state leaf and host
    mirror equal after the recovery and after one more sync, every restored
    tensor on the card. A snapshot taken on the card restores onto the CPU
    and one taken on the CPU onto the card, equal to each other."""
    from repro_torch.serve import recovery
    tree, rig = scene
    cfg = P.SessionConfig(tau=16.0, cut_budget=4096)
    kw = dict(focal=400.0, mode="pooled", bandwidth=[2e4, None], page_size=64)
    card = LodService(tree, cfg, 2, **kw)
    host = LodService(tree.to("cpu"), cfg, 2, device="cpu", **kw)
    host.codec = pytree.tree_map(lambda x: x.cpu(), card.codec)
    base = rig.left.pos.cpu().numpy()
    d_card, d_host = str(tmp_path / "card"), str(tmp_path / "host")
    # six syncs: the newest snapshot follows the fourth, so the tail holds
    # the partial sync, the evict, the shrink and the last sync
    mgr = recovery.RecoveryManager(card, d_card, every=4, keep=2)
    _churn_script(card, base, ops=mgr)
    _churn_script(host, base, ops=recovery.RecoveryManager(host, d_host, every=4, keep=2))
    del card, mgr
    torch.cuda.empty_cache()

    K.reset_launch_counts()
    rmgr, replayed = recovery.recover(tree, d_card)
    counts = K.launch_counts()
    records = recovery.SyncJournal.read(rmgr.journal.path)
    tail = [r["kind"] for r in records[len(records) - replayed:]]
    assert tail == ["sync", "evict", "shrink", "sync"], tail
    assert counts["vq_assign"] >= 2, counts
    svc = rmgr.service
    assert svc.device.type == "cuda" and _on(svc, "cuda")
    _assert_same_service(svc, host, "recovered")
    cams = {c: base + 0.5 for c in host.active_ids}
    st_c, st_h = rmgr.sync(cams), host.sync(cams)
    for f in dataclasses.fields(st_h):
        np.testing.assert_array_equal(getattr(st_c, f.name).cpu().numpy(),
                                      getattr(st_h, f.name).numpy(), err_msg=f.name)
    _assert_same_service(svc, host, "one more sync")

    snap_card = str(tmp_path / "snap_card")
    snap_host = str(tmp_path / "snap_host")
    svc.snapshot(snap_card)
    host.snapshot(snap_host)
    on_cpu = LodService.restore(tree.to("cpu"), snap_card, device="cpu")
    on_card = LodService.restore(tree, snap_host)
    assert _on(on_cpu, "cpu") and _on(on_card, "cuda")
    _assert_same_service(on_cpu, host, "card snapshot on the CPU")
    _assert_same_service(on_card, host, "CPU snapshot on the card")


# K7: every mask, both types, every padded head dim of the bf16 kernel
# (D 16..320), lengths that are not a multiple of the kernels' blocks,
# GQA groups 1, 2 and 8 (tolerances of tests/test_kernels.py). Every row
# sees at least one column in each case.
@pytest.mark.parametrize("b,h,hkv,lq,lk,d", [
    (1, 4, 4, 64, 64, 32),
    (2, 8, 2, 200, 200, 16),     # GQA, ragged
    (1, 4, 1, 77, 77, 128),      # MQA, ragged
    (1, 2, 1, 130, 130, 320),    # gemma3's head dim
    (2, 4, 2, 50, 90, 64),       # Lq != Lk
    (1, 8, 1, 1, 1, 64),         # one row, group 8
    (1, 2, 2, 65, 65, 80),       # D padded to 128, group 1
    (1, 4, 2, 2049, 2049, 128),  # qwen2.5's head dim, one row past 2048
    (1, 8, 1, 200, 200, 192),
    (2, 2, 1, 65, 65, 256),
    (1, 8, 4, 65, 200, 128),     # Lq != Lk, 2 tiles of kv past the last row
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0), (False, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_flash_attention(dev, b, h, hkv, lq, lk, d, causal, window, dtype):
    assert flash_attention.fwd_route(d, dtype).route == (
        "wgmma" if dtype == torch.bfloat16 else "tf32x3")
    g = torch.Generator(device=dev).manual_seed(lq * d + window)
    q = torch.randn((b, h, lq, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, hkv, lk, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, hkv, lk, d), generator=g, device=dev).to(dtype)
    before = flash_attention.flash_attention.launches
    out = flash_attention.flash_attention(q, k, v, causal=causal, window=window)
    ref = flash_attention.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol), \
        float((out.float() - ref.float()).abs().max())


def test_k7_takes_strided_views_and_raises_on_what_it_cannot_take(dev):
    """(B, S, H, D) tensors as transposed views, as models.attention passes
    them; the output keeps q's layout. The bf16 kernel reads by TMA and
    refuses what TMA cannot read as it lies."""
    g = torch.Generator(device=dev).manual_seed(0)
    q32 = torch.randn((2, 100, 8, 32), generator=g, device=dev)
    k32 = torch.randn((2, 100, 2, 32), generator=g, device=dev)
    v32 = torch.randn((2, 100, 2, 32), generator=g, device=dev)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        out = flash_attention.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2))
        ref = flash_attention.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                                    v.transpose(1, 2))
        assert out.transpose(1, 2).is_contiguous() and out.dtype == dtype
        assert torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
        with pytest.raises(ValueError, match="head dims"):
            flash_attention.flash_attention(q[..., :24].transpose(1, 2),
                                            k[..., :24].transpose(1, 2),
                                            v[..., :24].transpose(1, 2))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention.flash_attention(*(t.transpose(1, 2).half() for t in (q, k, v)))
    # bf16: a head stride of 36 elements (72 bytes), and a base 2 bytes off
    wide = torch.randn((2, 100, 8, 36), generator=g, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte alignment: head stride 72 B"):
        flash_attention.flash_attention(wide[..., :32].transpose(1, 2),
                                        k.transpose(1, 2), v.transpose(1, 2))
    shifted = torch.zeros(q.numel() + 8, dtype=q.dtype, device=dev)[1:1 + q.numel()]
    with pytest.raises(ValueError, match="16-byte alignment: base address"):
        flash_attention.flash_attention(shifted.view(q.shape).transpose(1, 2),
                                        k.transpose(1, 2), v.transpose(1, 2))


def test_dense_prefill_launches_k7_and_matches_the_cpu(dev):
    """A reduced qwen2.5 on the card: prefill launches K7 once a layer, and
    its logits, caches and decoded logits match the same model on the CPU."""
    cfg = reduced(get_arch("qwen2.5-3b"))
    model = dense.DenseLM(cfg, seed=0, device=dev)
    cpu_model = dense.DenseLM(cfg, seed=0, device="cpu")
    cpu_model.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 70)))
    before = flash_attention.flash_attention.launches
    lg, cache = dense.prefill(model, {"tokens": tok.to(dev)}, max_len=74)
    assert flash_attention.flash_attention.launches == before + cfg.n_layers
    lc, cache_c = dense.prefill(cpu_model, {"tokens": tok}, max_len=74)
    assert torch.allclose(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for a, b in zip(cache["layers"], cache_c["layers"]):
        assert torch.allclose(a["k"].cpu(), b["k"], rtol=1e-4, atol=1e-4)
    t = torch.argmax(lc[:, :cfg.vocab], -1)
    lg, cache = dense.decode_step(model, cache, {"token": t.to(dev)})
    lc, cache_c = dense.decode_step(cpu_model, cache_c, {"token": t})
    assert flash_attention.flash_attention.launches == before + cfg.n_layers
    assert torch.allclose(lg.cpu(), lc, rtol=1e-4, atol=1e-4) and cache["pos"] == 71


FAMILIES = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b", "seamless-m4t-medium",
            "paligemma-3b", "zamba2-2.7b", "xlstm-350m"]


@pytest.mark.parametrize("name", FAMILIES)
def test_family_prefill_launches_k7_on_card(dev, name):
    """A bf16 prefill of every new family at `reduced` size (xlstm at 7
    layers, so that it has an sLSTM block) launches K7 the expected number
    of times and decode none; logits finite, `pos` as on the CPU."""
    cfg = reduced(get_arch(name), dtype="bfloat16",
                  **(dict(n_layers=7) if name == "xlstm-350m" else {}))
    bundle = model_zoo.get_model(cfg)
    model = bundle.init(seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 64), generator=g, device=dev)}
    if cfg.family == "vlm":
        batch["img_embed"] = torch.randn((2, cfg.n_img_tokens, model_zoo.VISION_FEAT),
                                         generator=g, device=dev)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, 16, model_zoo.AUDIO_FEAT), generator=g, device=dev)
    want, before = model_zoo.k7_prefill_launches(cfg), flash_attention.flash_attention.launches
    logits, cache = bundle.prefill(model, batch, max_len=cfg.n_img_tokens + 66)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches - before == want
    logits, cache = bundle.decode_step(model, cache, {"token": logits[:, :cfg.vocab].argmax(-1)})
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches - before == want
    assert torch.isfinite(logits).all() and cache["pos"] == cfg.n_img_tokens + 65


def _of_scale(ours, ref) -> float:
    """max |ours - ref| over the largest |ref|."""
    return float((ours.float() - ref.float()).abs().max()) / max(float(ref.float().abs().max()),
                                                                  1e-30)


# K7's backward: within 1e-5 (float32) and 2e-2 (bf16) of each gradient's
# largest |value|, against the plain autograd gradient and against
# `flash_attention_backward_plain` (the kernel's own recurrence)
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("shape", [(2, 300, 8, 2, 64, 0), (1, 257, 4, 4, 128, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_autograd_matches_plain(dev, shape, dtype):
    """With grad on, K7 runs inside its autograd Function: one forward
    launch and one backward launch, whose q, k and v gradients are those of
    K7's plain version on the same inputs, on the strided (B, H, L, D)
    views of (B, S, H, D) tensors: a causal GQA shape and a windowed one."""
    b, s, h, hkv, d, window = shape
    g = torch.Generator(device=dev).manual_seed(s + d)
    base = [torch.randn((b, s, n, d), generator=g, device=dev).to(dtype)
            for n in (h, hkv, hkv)]
    w = torch.randn((b, h, s, d), generator=g, device=dev)
    grads = []
    for fn in (flash_attention.flash_attention, flash_attention.flash_attention_plain):
        leaves = [t.clone().requires_grad_() for t in base]
        before = (flash_attention.flash_attention.launches,
                  flash_attention.flash_attention_backward.launches)
        out = fn(*(t.transpose(1, 2) for t in leaves), causal=True, window=window)
        assert out.requires_grad
        (out.float() * w).sum().backward()
        torch.cuda.synchronize()
        launched = (flash_attention.flash_attention.launches - before[0],
                    flash_attention.flash_attention_backward.launches - before[1])
        assert launched == ((1, 1) if fn is flash_attention.flash_attention else (0, 0))
        grads.append([t.grad for t in leaves])
    for ours, ref, name in zip(grads[0], grads[1], "qkv"):
        assert ours.dtype == dtype and ours.shape == ref.shape
        assert _of_scale(ours, ref) <= BWD_TOL[dtype], (name, _of_scale(ours, ref))
        assert ours.abs().max() > 0


def _bwd_inputs(dev, b, h, hkv, lq, lk, d, dtype, seed):
    """q, k, v, dout as the model's strided (B, H, L, D) views."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, n_l, n, d), generator=g, device=dev).to(dtype).transpose(1, 2)
            for n_l, n in ((lq, h), (lk, hkv), (lk, hkv), (lq, h))]


# every head-dim bucket of the backward (80 padded inside 128, 192 inside
# 256: a TMA box wholly past D) on both routes, GQA groups 1, 2, 4 and 8,
# lengths off the blocks (333: ragged at every block size), Lq != Lk, rows
# with no visible column (causal, window 48, Lq 300 > Lk 100), qwen2.5-3b's
# training shape and a head-dim-80 GQA group; at buckets 256 and 320 (the
# wgmma passes whose warpgroups split dV and dK) groups 1, 2 and 8 each
@pytest.mark.parametrize("b,h,hkv,lq,lk,d", [
    (1, 8, 2, 257, 257, 64),
    (2, 4, 4, 130, 130, 80),
    (1, 8, 1, 200, 200, 128),
    (1, 4, 2, 100, 100, 256),
    (1, 2, 1, 97, 97, 320),
    (1, 4, 2, 65, 200, 128),
    (1, 4, 2, 300, 100, 64),
    (1, 16, 2, 4096, 4096, 128),
    (1, 8, 2, 300, 300, 80),
    (1, 4, 4, 333, 333, 256),
    (1, 8, 1, 333, 333, 256),
    (1, 4, 4, 333, 333, 320),
    (1, 8, 4, 333, 333, 320),
    (1, 8, 1, 333, 333, 320),
    (1, 4, 2, 333, 333, 192),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0), (False, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_backward_matches_its_plain_version(dev, b, h, hkv, lq, lk, d, causal, window,
                                               dtype):
    """The backward kernel against `flash_attention_backward_plain` on the
    same (out, lse), on strided views; and the forward kernel's lse against
    the plain version's (+inf exactly where a row sees no column)."""
    q, k, v, dout = _bwd_inputs(dev, b, h, hkv, lq, lk, d, dtype, lq * d + window)
    out, lse = flash_attention.flash_attention_plain(q, k, v, causal=causal, window=window,
                                                     return_lse=True)
    lse_k = torch.empty_like(lse)
    out_k = flash_attention._launch(q, k, v, causal, window, lse_k)
    before = flash_attention.flash_attention_backward.launches
    got = flash_attention.flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                                   window=window)
    ref = flash_attention.flash_attention_backward_plain(q, k, v, out, lse, dout,
                                                         causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_backward.launches == before + 1
    empty = torch.isinf(lse)
    assert torch.equal(torch.isinf(lse_k), empty) and (lse_k[empty] > 0).all()
    lse_tol = 1e-5 if dtype == torch.float32 else 1e-4
    assert torch.allclose(lse_k[~empty], lse[~empty], rtol=lse_tol, atol=lse_tol)
    assert (out_k[empty] == 0).all()
    for ours, want, t, name in zip(got, ref, (q, k, v), "qkv"):
        assert ours.dtype == dtype and ours.shape == t.shape and ours.stride() == t.stride()
        assert _of_scale(ours, want) <= BWD_TOL[dtype], (name, _of_scale(ours, want))
    assert (got[0][empty] == 0).all()


def _route(d, dtype):
    return "tf32x3" if dtype == torch.float32 else "wgmma"


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.bfloat16, 128),
                                     (torch.bfloat16, 80), (torch.bfloat16, 256),
                                     (torch.float32, 64), (torch.float32, 80),
                                     (torch.float32, 256), (torch.float32, 320),
                                     (torch.bfloat16, 320), (torch.bfloat16, 192)])
def test_k7_backward_is_deterministic(dev, dtype, d):
    """Two backward runs on the same inputs give the same bits (no atomics:
    a GQA group's dk and dv are summed over its heads in order), on every
    route: bf16 on wgmma at every bucket (80 inside 128, 192 inside 256),
    float32 at every bucket (80 inside 128) on tf32x3."""
    assert flash_attention.bwd_route(d, dtype).route == _route(d, dtype)
    q, k, v, dout = _bwd_inputs(dev, 2, 8, 2, 333, 333, d, dtype, 3)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    out = flash_attention._launch(q, k, v, True, 0, lse)
    runs = [flash_attention.flash_attention_backward(q, k, v, out, lse, dout, causal=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [64, 80, 128, 256, 320])
def test_k7_float32_forward_is_deterministic(dev, d):
    """Two runs of the float32 forward (three TF32 products, at every
    head-dim bucket) on the same inputs give the same output and lse bits."""
    assert flash_attention.fwd_route(d, torch.float32).route == "tf32x3"
    assert flash_attention.fwd_route(d, torch.float32).d_pad == \
        flash_attention.bwd_route(d, torch.float32).d_pad
    q, k, v, _ = _bwd_inputs(dev, 2, 8, 2, 333, 333, d, torch.float32, 4)
    runs = []
    for _ in range(2):
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
        runs.append((flash_attention._launch(q, k, v, True, 40, lse), lse))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_k7_backward_needs_and_raises_on_what_it_cannot_take(dev):
    """Only the asked-for gradients; anything the kernel cannot take raises
    (nothing falls back to the plain version)."""
    q, k, v, dout = _bwd_inputs(dev, 1, 4, 2, 64, 64, 64, torch.bfloat16, 1)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    out = flash_attention._launch(q, k, v, True, 0, lse)
    full = flash_attention.flash_attention_backward(q, k, v, out, lse, dout)
    dq, dk, dv = flash_attention.flash_attention_backward(q, k, v, out, lse, dout,
                                                          need_dkv=False)
    assert dk is None and dv is None and torch.equal(dq, full[0])
    dq, dk, dv = flash_attention.flash_attention_backward(q, k, v, out, lse, dout,
                                                          need_dq=False)
    assert dq is None and torch.equal(dk, full[1]) and torch.equal(dv, full[2])
    bwd = flash_attention.flash_attention_backward
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bwd(q.half(), k.half(), v.half(), out.half(), lse, dout.half())
    with pytest.raises(ValueError, match="head dims"):
        bwd(q[..., :24], k[..., :24], v[..., :24], out[..., :24], lse, dout[..., :24])
    with pytest.raises(ValueError, match="dout must have q's shape"):
        bwd(q, k, v, out, lse, dout.float())
    with pytest.raises(ValueError, match="lse must be"):
        bwd(q, k, v, out, lse[:, :, :32], dout)
    with pytest.raises(ValueError, match="contiguous head-dim"):
        bwd(q, k, v, out, lse, dout.transpose(2, 3).contiguous().transpose(2, 3))


@pytest.mark.parametrize("d", [64, 256, 320])
def test_k7_backward_wgmma_route_raises_on_a_misaligned_tensor(dev, d):
    """bf16 takes the wgmma route at every bucket, whose TMA reads q, k, v
    and dout as they lie: a base 2 bytes off 16 raises (nothing is copied,
    and nothing falls back to another route), as does a head stride that is
    not a multiple of 16 bytes; the aligned call runs."""
    q, k, v, dout = _bwd_inputs(dev, 1, 4, 2, 64, 64, d, torch.bfloat16, 2)
    assert flash_attention.bwd_route(d, torch.bfloat16).route == "wgmma"
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=dev)
    out = flash_attention._launch(q, k, v, True, 0, lse)
    bwd = flash_attention.flash_attention_backward
    before = bwd.launches
    shifted = torch.empty(dout.numel() + 1, dtype=dout.dtype, device=dev)[1:]
    shifted = shifted.view(dout.shape).copy_(dout)
    with pytest.raises(ValueError, match="reads dout by TMA.*base address"):
        bwd(q, k, v, out, lse, shifted)
    wide = torch.zeros((1, 64, 4, d + 4), dtype=dout.dtype, device=dev)[..., :d]
    wide.copy_(dout.transpose(1, 2))
    with pytest.raises(ValueError, match=f"reads dout by TMA.*head stride {2 * (d + 4)} B"):
        bwd(q, k, v, out, lse, wide.transpose(1, 2))
    assert bwd.launches == before
    bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert bwd.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_through_local_map_on_a_1x1_mesh(dev, dtype, tmp_path):
    """`models.attention` on DTensors of a 1×1 mesh (a world of one NCCL
    rank) runs K7 per shard through `local_map`: one launch, and the
    output equals K7's on the plain tensors bit for bit."""
    from repro_torch.launch.mesh import destroy_fleet_group, init_fleet_group, make_mesh
    from repro_torch.models.attention import attention
    from repro_torch.sharding.context import activation_rules, meshed
    from repro_torch.sharding.partitioning import place

    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn((2, 384, n, 128), generator=g, device=dev).to(dtype)
               for n in (16, 2, 2))
    before = flash_attention.flash_attention.launches
    ref = attention(q, k, v, causal=True)
    assert flash_attention.flash_attention.launches == before + 1
    init_fleet_group(str(tmp_path / "store"), 0, 1, "nccl", device=dev)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=dev)
        spec = ("data", None, "model", None)
        dq, dk, dv = (place(t, mesh, spec) for t in (q, k, v))
        with meshed(activation_rules(mesh)):
            out = attention(dq, dk, dv, causal=True)
        torch.cuda.synchronize()
        assert flash_attention.flash_attention.launches == before + 2
        assert tuple(out.placements) == tuple(dq.placements)
        assert torch.equal(out.to_local(), ref)
    finally:
        destroy_fleet_group()


TRAIN_FAMILIES = ["qwen2.5-3b"] + FAMILIES


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", TRAIN_FAMILIES)
def test_family_train_step_on_card(dev, name, remat):
    """A float32 `reduced` config of each family on the card (xlstm at 7
    layers): the loss's gradient reaches every parameter, finite and
    non-zero, and matches the same model's on the CPU; K7 launches
    `model_zoo.k7_train_launches` times (the prefill's count, plus one for
    each attention inside a remat unit with `remat`); a train step moves
    every parameter."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    cfg = reduced(get_arch(name), remat=remat,
                  **(dict(n_layers=7) if name == "xlstm-350m" else {}))
    bundle = model_zoo.get_model(cfg)
    model = bundle.init(seed=0, device=dev)
    cpu_model = bundle.init(seed=0, device="cpu")
    cpu_model.load_state_dict({k: t.cpu() for k, t in model.state_dict().items()})
    rng = np.random.default_rng(0)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (2, 64)),
              "targets": rng.integers(0, cfg.vocab, (2, 64))}
    for key, shp in model_zoo.stub_shapes(cfg, 64).items():
        arrays[key] = rng.normal(size=(2,) + shp).astype(np.float32)
    batch = {k: torch.from_numpy(a) for k, a in arrays.items()}
    before = flash_attention.flash_attention.launches
    loss = bundle.loss(model, {k: t.to(dev) for k, t in batch.items()})
    params = list(model.parameters())
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches - before == \
        model_zoo.k7_train_launches(cfg)
    cpu_loss = bundle.loss(cpu_model, batch)
    cpu_grads = torch.autograd.grad(cpu_loss, list(cpu_model.parameters()))
    assert torch.allclose(loss.cpu(), cpu_loss, rtol=1e-5)
    for (n, _p), a, c in zip(model.named_parameters(), grads, cpu_grads):
        assert torch.isfinite(a).all() and a.abs().max() > 0, n
        assert torch.allclose(a.cpu(), c, rtol=0, atol=2e-4 * float(c.abs().max())), n
    step = make_train_step(bundle, opt.OptimizerConfig(lr=1e-3, warmup_steps=0))
    old = [p.detach().clone() for p in params]
    _m, state, _e, met = step(model, opt.init(dict(model.named_parameters())), None, batch)
    assert torch.isfinite(met["loss"]) and int(state.step) == 1
    for (n, p), o in zip(model.named_parameters(), old):
        assert not torch.equal(p.detach(), o), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_at_zamba2_shared_block_shape(dev, dtype):
    """K7 at zamba2-2.7b's shared attention (32/32 heads of 80, which the
    bf16 kernel pads to 128; 2048 positions, causal) against its plain
    version, through the model's (B, S, H, D) views."""
    cfg = get_arch("zamba2-2.7b")
    g = torch.Generator(device=dev).manual_seed(80)
    q, k, v = (torch.randn((1, 2048, n, cfg.hd), generator=g, device=dev).to(dtype)
               .transpose(1, 2) for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    out = flash_attention.flash_attention(q, k, v, causal=True)
    ref = flash_attention.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol), \
        float((out.float() - ref.float()).abs().max())


def test_meshed_service_on_card_matches_meshless(scene, tmp_path):
    """A service on a 1×1 serving mesh (NCCL, a world of this one process)
    against the meshless one on the card: a growth, an evict, a live
    `resize_mesh` off the mesh and back, and the pooled render, bit for
    bit."""
    from repro_torch.launch.mesh import destroy_fleet_group, init_fleet_group, make_fleet_mesh
    tree, rig = scene
    cfg = P.SessionConfig(tau=16.0, cut_budget=4096)
    base = rig.left.pos.cpu().numpy()
    init_fleet_group(str(tmp_path / "store"), 0, 1, "nccl")
    try:
        mesh = make_fleet_mesh(1, 1)
        plain = LodService(tree, cfg, 2, focal=400.0, mode="pooled")
        meshed = LodService(tree, cfg, 2, focal=400.0, mode="pooled", mesh=mesh)
        meshed.codec = plain.codec
        K.reset_launch_counts()
        for k, op in enumerate(("sync", "admit", "sync", "evict", "off", "sync", "on", "sync")):
            for svc in (plain, meshed):
                if op == "admit":
                    svc.admit(base + [0.8, 0.0, 0.0])
                elif op == "evict":
                    svc.evict(0)
                elif op in ("off", "on"):
                    if svc is meshed:
                        svc.resize_mesh(None if op == "off" else mesh)
            if op == "sync":
                cams = {c: base + [0.3 * c + 0.1 * k, 0.0, 0.0] for c in plain.active_ids}
                a, b = plain.sync(cams), meshed.sync(cams)
                for f in dataclasses.fields(a):
                    assert torch.equal(getattr(a, f.name), getattr(b, f.name)), (k, f.name)
            for (key, x), (_k, y) in zip(pytree.flatten_with_paths(plain.state),
                                         pytree.flatten_with_paths(meshed.state)):
                assert torch.equal(x, y), (k, key)
        assert K.launch_counts()["lod_pair_sweep"] >= 2 and meshed.capacity == 4
        rigs = [C.StereoRig(left=rig.left.translated(
            torch.tensor([0.4 * c, 0.0, 0.0], device=rig.left.pos.device)))
            for c in plain.active_ids]
        pl, pr, _ = plain.render_fallback(rigs, list_len=64, max_pairs=1 << 18, path="pooled")
        ml, mr, _ = meshed.render_fallback(rigs, list_len=64, max_pairs=1 << 18, path="pooled")
        assert torch.equal(pl, ml) and torch.equal(pr, mr)
    finally:
        destroy_fleet_group()
