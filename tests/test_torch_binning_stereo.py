"""Port parity: tile binning and the stereo shift-merge (K4's front end and
plain merge) of `repro_torch` against the JAX package, on the same splats."""

import dataclasses

import numpy as np
import pytest
import torch

from _merge_cases import merge_sources
from _torch_parity import assert_close, assert_equal, to_torch_splats, to_torch_tile_lists

from repro.core import binning as jbin
from repro.core import stereo as jst
from repro.core.camera import StereoRig, make_camera
from repro.core.gaussians import random_gaussians
from repro.core.projection import depth_ranks, project
from repro.kernels import ops as kops
from repro.kernels import ref as kref
from repro.kernels.stereo_shift import stereo_merge_pallas
from repro_torch import kernels as tkernels
from repro_torch.core import binning as tbin
from repro_torch.core import stereo as tst
from repro_torch.kernels import binning as kbin
from repro_torch.kernels import stereo_shift as tshift


def _scene(n, seed, list_len=64, max_pairs=1 << 14, width=96, height=64):
    """The JAX kernel tests' scene (tests/test_kernels.py::_scene)."""
    g = random_gaussians(np.random.default_rng(seed), n, sh_degree=1, extent=5.0)
    cam = make_camera([0, -15, 2], [0, 0, 0], focal_px=200.0, width=width,
                      height=height, near=0.25)
    rig = StereoRig(left=cam, baseline=0.06)
    tile = 16
    n_cat = jst.n_categories(rig.max_disparity_px(), tile)
    wide = dataclasses.replace(cam, width=(-(-cam.width // tile) + n_cat - 1) * tile)
    s = project(g, rig, wide)
    ranks = depth_ranks(s)
    cfg = jbin.BinConfig(tile=tile, max_pairs=max_pairs, list_len=list_len)
    return dict(cam=cam, wide=wide, s=s, ranks=ranks, n_cat=n_cat, tile=tile,
                jcfg=cfg, tcfg=tbin.BinConfig(tile=tile, max_pairs=max_pairs,
                                              list_len=list_len),
                ts=to_torch_splats(s), tranks=torch.tensor(np.asarray(ranks)))


def _same_lists(got, ref):
    assert_equal(got.lists, ref.lists, "lists")
    assert_equal(got.counts, ref.counts, "counts")
    assert bool(got.overflow) == bool(ref.overflow)
    assert (got.tiles_x, got.tiles_y) == (ref.tiles_x, ref.tiles_y)
    assert got.lists.dtype == torch.int32 and got.counts.dtype == torch.int32


@pytest.mark.parametrize("n,seed,list_len,max_pairs", [
    (400, 0, 64, 1 << 14), (400, 1, 64, 1 << 14), (800, 2, 64, 1 << 14),
    (400, 3, 16, 1 << 14), (400, 4, 64, 1 << 9)])
def test_bin_left_right_exact(n, seed, list_len, max_pairs):
    """TileLists ids, counts and overflow (list and pair budgets) exact."""
    sc = _scene(n, seed, list_len, max_pairs)
    ref = jbin.bin_left(sc["s"], sc["wide"].width, sc["cam"].height, sc["jcfg"], sc["ranks"])
    got = tbin.bin_left(sc["ts"], sc["wide"].width, sc["cam"].height, sc["tcfg"],
                        sc["tranks"])
    _same_lists(got, ref)
    ref_r = jbin.bin_right(sc["s"], sc["cam"].width, sc["cam"].height, sc["jcfg"],
                           sc["ranks"])
    got_r = tbin.bin_right(sc["ts"], sc["cam"].width, sc["cam"].height, sc["tcfg"],
                           sc["tranks"])
    _same_lists(got_r, ref_r)
    assert_close(tbin.corner_r2(sc["ts"].conic, sc["ts"].opacity),
                 jbin.corner_r2(sc["s"].conic, sc["s"].opacity), 1e-6, 0.0)


@pytest.mark.parametrize("n,seed,list_len", [(400, 0, 64), (400, 1, 64),
                                             (800, 2, 64), (400, 3, 12)])
def test_stereo_merge_exact(n, seed, list_len):
    """The port's K4 front end + plain merge equals the JAX `stereo_lists`,
    the JAX merge front end + Pallas merge kernel, and the port's own
    sort-based `stereo_lists` — ids, counts and the overflow flag."""
    sc = _scene(n, seed, list_len)
    kw = dict(tile=sc["tile"], width=sc["cam"].width, n_cat=sc["n_cat"])
    left = jbin.bin_left(sc["s"], sc["wide"].width, sc["cam"].height, sc["jcfg"],
                         sc["ranks"])
    tleft = to_torch_tile_lists(left)
    ref = jst.stereo_lists(left, sc["s"], sc["ranks"], **kw)

    tkernels.reset_launch_counts()
    got = tst.stereo_merge(tleft, sc["ts"], sc["tranks"], **kw)
    assert tkernels.launch_counts()["stereo_merge"] == 0  # CPU: plain version
    _same_lists(got, ref)
    _same_lists(tst.stereo_lists(tleft, sc["ts"], sc["tranks"], **kw), ref)

    # the merge front end and the merge itself, piece by piece
    jr, ji = kops.build_merge_sources(left, sc["s"], sc["ranks"], **kw)
    tr, ti = tst.build_merge_sources(tleft, sc["ts"], sc["tranks"], **kw)
    assert_equal(tr, jr)
    assert_equal(ti, ji)
    out, count, ovf = tshift.stereo_merge_kernel(tr, ti)
    p_out, p_count, p_ovf = stereo_merge_pallas(jr, ji)
    assert_equal(out, p_out)
    assert_equal(count, p_count)
    assert_equal(ovf, p_ovf)
    r_out, r_count = kref.ref_stereo_merge(jr, ji)
    assert_equal(out, r_out)
    assert_equal(count, r_count)
    if list_len == 12:
        assert bool(ovf.any())  # the narrow list really overflows


@pytest.mark.parametrize("n_cat,l_len", [(44, 16), (44, 7), (23, 7), (33, 1), (1, 7)])
def test_stereo_merge_adversarial_sources(n_cat, l_len):
    """The plain merge against the Pallas kernel (interpret mode) and
    `kref.ref_stereo_merge` on numpy-seeded sources: n_cat up to 44 (the VR
    rig at tile 8), ranks tied across rows and repeated inside a row,
    all-INF tiles, and counts below, at and above L."""
    r, i = merge_sources(n_cat * 100 + l_len, n_cat, l_len)
    out, count, ovf = tshift.stereo_merge_plain(torch.from_numpy(r), torch.from_numpy(i))
    p_out, p_count, p_ovf = stereo_merge_pallas(r, i)
    assert_equal(out, p_out)
    assert_equal(count, p_count)
    assert_equal(ovf, p_ovf)
    r_out, r_count = kref.ref_stereo_merge(r, i)
    assert_equal(out, r_out)
    assert_equal(count, r_count)
    counts = count.tolist()
    assert counts[:2] == [0, 1]
    if n_cat * l_len > l_len + 1:
        assert {l_len - 1, l_len, l_len + 1} <= set(counts) and bool(ovf.any())


def test_n_categories_and_stats():
    assert tst.n_categories(336.0, 16) == jst.n_categories(336.0, 16) == 23
    sc = _scene(400, 5)
    left = tbin.bin_left(sc["ts"], sc["wide"].width, sc["cam"].height, sc["tcfg"],
                         sc["tranks"])
    right = tst.stereo_merge(left, sc["ts"], sc["tranks"], tile=sc["tile"],
                             width=sc["cam"].width, n_cat=sc["n_cat"])
    hits = torch.rand(left.lists.shape, generator=torch.Generator().manual_seed(0)) < 0.5
    jl = jbin.TileLists(lists=np.asarray(left.lists), counts=np.asarray(left.counts),
                        overflow=np.asarray(left.overflow), tiles_x=left.tiles_x,
                        tiles_y=left.tiles_y)
    jr = jbin.TileLists(lists=np.asarray(right.lists), counts=np.asarray(right.counts),
                        overflow=np.asarray(right.overflow), tiles_x=right.tiles_x,
                        tiles_y=right.tiles_y)
    ref = jst.alpha_skip_stats(jl, jr, np.asarray(hits), sc["s"])
    got = tst.alpha_skip_stats(left, right, hits, sc["ts"])
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.right_candidates > 0


def _bin_args(sc, max_pairs=None):
    cfg = sc["tcfg"] if max_pairs is None else dataclasses.replace(sc["tcfg"],
                                                                   max_pairs=max_pairs)
    s = sc["ts"]
    return (s.mean2d, s.ext, sc["tranks"], s.visible, sc["wide"].width, sc["cam"].height,
            cfg), dict(conic=s.conic, opacity=s.opacity)


@pytest.mark.parametrize("max_pairs", [1 << 14, 300])
def test_bin_tiles_on_cpu_is_the_plain_version(max_pairs):
    """CPU tensors take `bin_tiles_plain`, whatever the budget: no chain launch."""
    args, kw = _bin_args(_scene(400, 6), max_pairs)
    before = kbin.bin_tiles_kernel.launches
    _same_lists(tbin.bin_tiles(*args, **kw), tbin.bin_tiles_plain(*args, **kw))
    assert kbin.bin_tiles_kernel.launches == before


def test_bin_tiles_plain_with_no_splats():
    """m = 0: every list empty, no overflow (nothing to gather from)."""
    e = torch.zeros((0, 2))
    got = tbin.bin_tiles_plain(e, e, torch.zeros((0,), dtype=torch.int32),
                               torch.zeros((0,), dtype=torch.bool), 70, 40,
                               tbin.BinConfig(tile=16, max_pairs=1 << 10, list_len=8),
                               conic=torch.zeros((0, 3)), opacity=torch.zeros((0,)))
    assert (got.tiles_x, got.tiles_y) == (5, 3)
    assert got.lists.shape == (15, 8) and bool((got.lists == -1).all())
    assert got.counts.dtype == torch.int32 and int(got.counts.abs().sum()) == 0
    assert not bool(got.overflow)


def _kernel_inputs(m=6):
    g = torch.Generator().manual_seed(0)
    return dict(mean2d=torch.rand((m, 2), generator=g) * 50, ext=torch.rand((m, 2), generator=g),
                ranks=torch.randperm(m, generator=g).to(torch.int32),
                visible=torch.ones((m,), dtype=torch.bool), r2=torch.rand((m,), generator=g))


@pytest.mark.parametrize("case,match", [
    ("mean2d_float64", "mean2d must be torch.float32"),
    ("ext_shape", r"ext must be torch.float32 \(6, 2\)"),
    ("ranks_int64", "ranks must be torch.int32"),
    ("visible_uint8", "visible must be torch.bool"),
    ("r2_float64", "r2 must be torch.float32"),
    ("mean2d_strided", "mean2d must be contiguous"),
    ("ext_transposed", "ext must be contiguous"),
    ("ranks_strided", "ranks must be contiguous"),
    ("list_len", "out of range"),
    ("max_pairs", "out of range"),
    ("cpu", "needs CUDA tensors")])
def test_bin_tiles_kernel_rejects_what_it_cannot_take(case, match):
    """The chain's wrapper checks types, shapes and layouts before it looks
    for a card, so each check shows on the CPU too."""
    kw = _kernel_inputs()
    grid = dict(width=64, height=48, tile=16, max_pairs=1 << 10, list_len=8)
    if case == "mean2d_float64":
        kw["mean2d"] = kw["mean2d"].double()
    elif case == "ext_shape":
        kw["ext"] = kw["ext"][:5]
    elif case == "ranks_int64":
        kw["ranks"] = kw["ranks"].long()
    elif case == "visible_uint8":
        kw["visible"] = kw["visible"].to(torch.uint8)
    elif case == "r2_float64":
        kw["r2"] = kw["r2"].double()
    elif case == "mean2d_strided":
        kw["mean2d"] = torch.zeros((6, 4))[:, 1:3]
    elif case == "ext_transposed":
        kw["ext"] = torch.zeros((2, 6)).T
    elif case == "ranks_strided":
        kw["ranks"] = torch.zeros((12,), dtype=torch.int32)[::2]
    elif case in ("list_len", "max_pairs"):
        grid[case] = -1
    with pytest.raises(ValueError, match=match):
        kbin.bin_tiles_kernel(kw["mean2d"], kw["ext"], kw["ranks"], kw["visible"], kw["r2"],
                              **grid)


@pytest.mark.parametrize("n_tiles", [1, 2, 3, 256, 257, 20838, 32767, 32768, 32769,
                                     65536, 65537, 78250])
def test_key_width_against_a_numpy_count(n_tiles):
    """The sort key holds the largest tile id in as few bits as it can: 16
    up to 65536 tiles (the quest3 grid, 151 × 138 = 20838, takes 15)."""
    ids = np.arange(n_tiles, dtype=np.int64)
    bits = max(1, int(np.max(ids)).bit_length())
    assert kbin.key_bits(n_tiles) == bits
    assert np.all(ids < 2 ** bits) and (bits == 1 or np.max(ids) >= 2 ** (bits - 1))
    assert kbin.wide_key(n_tiles) == (n_tiles > 65536)


@pytest.mark.parametrize("max_pairs,m,n_tiles,want", [
    (1 << 28, 1 << 20, 20838, (1 << 28) // 2048), (1 << 14, 400, 40, 8),
    (2049, 10, 1000, 2), (2048, 10, 1000, 1), (0, 10, 10, 0), (1 << 20, 0, 10, 0),
    (1 << 20, 3, 7, 1)])
def test_chunk_count(max_pairs, m, n_tiles, want):
    assert kbin.chunk_count(max_pairs, m, n_tiles) == want == int(
        np.ceil(min(max_pairs, m * n_tiles) / kbin.PAIRS_PER_BLOCK))


@pytest.mark.parametrize("seed,m", [(0, 1), (1, 37), (2, 1000), (3, 0)])
def test_emit_bases_against_a_numpy_count(seed, m):
    """Each splat's start among the kept pairs in (rank, index) order, less
    its start in index order, and the kept total, against a loop over the
    splats in that order; the ranks have ties and the counts zeros."""
    rng = np.random.default_rng(seed)
    kept = rng.integers(0, 5, m) * (rng.random(m) < 0.7)
    ranks = rng.integers(0, max(m // 3, 1), m)
    start, at = np.zeros(m, np.int64), 0
    for g in sorted(range(m), key=lambda g: (ranks[g], g)):
        start[g], at = at, at + kept[g]
    index_start = np.concatenate([[0], np.cumsum(kept)[:-1]]) if m else np.zeros(0)
    base, total = kbin.emit_bases(torch.from_numpy(kept.astype(np.int32)),
                                  torch.from_numpy(ranks.astype(np.int32)))
    assert base.dtype == torch.int64 and int(total) == int(kept.sum())
    np.testing.assert_array_equal(base.numpy(), start - index_start)
    ex = kbin.exclusive_sum(torch.from_numpy(kept.astype(np.int32)))
    np.testing.assert_array_equal(ex.numpy(), index_start)
