"""Port parity for the slice as a whole: the single-client collaborative
session of `repro_torch` against the JAX session on the same tree and
trajectory, built through `repro_torch.convert`, with raw Δcut rows
(`use_compression=False`) and with the default compressed wire."""

import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close, assert_equal, saturating_scene, to_torch_codec,
                           to_torch_rig, to_torch_tree)

from repro.core import compression as jcomp
from repro.core import pipeline as jpipe
from repro.core.camera import StereoRig, TrajectoryConfig, make_camera, walk_trajectory
from repro.core.gaussians import CityConfig, Gaussians, generate_city
from repro.core.lod_tree import build_lod_tree
from repro_torch import kernels as tkernels
from repro_torch.core import compression as tcomp
from repro_torch.core import pipeline as tpipe
from repro_torch.core.stereo import alpha_skip_stats
from repro_torch.kernels import rasterize as traster
from repro_torch.kernels.vq_assign import vq_assign_plain
from repro_torch.render import stages as tstages

N_FRAMES = 9


@pytest.fixture(scope="module")
def setup():
    leaves = generate_city(CityConfig(blocks_x=2, blocks_y=2, leaf_density=0.10, seed=2))
    tree = build_lod_tree(leaves, target_subtrees=16, seed=0)
    rig0 = StereoRig(left=make_camera([30, 30, 1.7], [60, 60, 1.5], focal_px=200.0,
                                      width=96, height=64, near=0.2), baseline=0.06)
    rigs = [StereoRig(left=dataclasses.replace(c, near=0.2), baseline=0.06)
            for c in walk_trajectory(TrajectoryConfig(seed=0, speed_mps=20.0), N_FRAMES,
                                     (100.0, 100.0), focal_px=200.0, width=96, height=64)]
    return tree, to_torch_tree(tree), rig0, rigs


CFG = dict(tau=32.0, w=4, w_star=2, cut_budget=8192, tile=16, list_len=256,
           max_pairs=1 << 16, use_compression=False)


def test_session_exact_over_frames(setup):
    tree, ttree, rig0, rigs = setup
    js = jpipe.CollaborativeSession(tree, jpipe.SessionConfig(**CFG), rig0)
    tkernels.reset_launch_counts()
    ts = tpipe.CollaborativeSession(ttree, tpipe.SessionConfig(**CFG), to_torch_rig(rig0),
                                    device=CPU)
    assert ts.bytes_per_g == js.bytes_per_g
    synced = 0
    for rig in rigs:
        jst, jout = js.step(rig, render=True)
        tst, tout = ts.step(to_torch_rig(rig), render=True)
        assert dataclasses.asdict(tst) == dataclasses.asdict(jst), tst.frame
        synced += tst.synced
        assert_equal(ts.state.cut_gids, js.state.cut_gids)
        for f in ("mu", "log_scale", "quat", "opacity", "sh"):
            assert_equal(getattr(ts.client_store, f), getattr(js.client_store, f), f)
        assert_equal(ts.client.has, js.client.has)
        assert_equal(ts.mgr_state.client_has, js.mgr_state.client_has)
        assert_equal(ts.temporal.slab_cut0, js.temporal.slab_cut0)
        (tl, tr, (_s, tll, trl, tstats)), (jl, jr, (_js, jll, jrl, jstats)) = tout, jout
        # the splats here come from each package's own projection, which
        # agree to 2e-5 (K3's tolerance); colors inherit that, not 1e-5
        assert_close(tl, jl, 1e-4, 1e-5)
        assert_close(tr, jr, 1e-4, 1e-5)
        assert_equal(tll.lists, jll.lists)
        assert_equal(trl.lists, jrl.lists)
        assert bool(trl.overflow) == bool(jrl.overflow)
        assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
        assert float(tl.max()) > 0
    assert synced == 3 and ts.frame_index == N_FRAMES and ts.sync_index == 3
    assert all(v == 0 for v in tkernels.launch_counts().values())  # CPU: plain versions


def test_functional_core_steps(setup):
    tree, ttree, rig0, rigs = setup
    jcfg, tcfg = jpipe.SessionConfig(**CFG), tpipe.SessionConfig(**CFG)
    jcodec, jbpg = jpipe.session_wire_format(tree, jcfg)
    tcodec, tbpg = tpipe.session_wire_format(ttree, tcfg)
    jstate, tstate = jpipe.session_init(tree, jcfg), tpipe.session_init(ttree, tcfg)
    for rig in rigs[:5]:
        pos = np.asarray(rig.left.pos)
        jstate, jst = jpipe.session_step(tree, jcodec, jcfg, jstate, pos,
                                         np.float32(200.0), jbpg)
        tstate, tst = tpipe.session_step(ttree, tcodec, tcfg, tstate, pos, 200.0, tbpg)
        for f in dataclasses.fields(tst):
            assert_equal(getattr(tst, f.name), getattr(jst, f.name), f.name)
    fresh = tpipe.admit_step(tstate)
    assert fresh.frame_index == 0 and int((fresh.cut_gids >= 0).sum()) == 0
    assert_equal(tpipe.evict_step(tstate).client_store.quat,
                 tpipe.session_init(ttree, tcfg).client_store.quat)
    img_l, img_r, _ = tpipe.client_render_step(tcfg, tstate, to_torch_rig(rigs[4]))
    assert torch.isfinite(img_l).all() and img_l.shape == (64, 96, 3)


def test_apply_payload_writes_gid_zero(setup):
    """A Δcut that carries gid 0 beside -1 padding writes the tree's row 0
    into the store: padding writes nothing, so it cannot put the old row 0
    back."""
    _tree, ttree, *_ = setup
    store = tpipe.session_init(ttree, tpipe.SessionConfig(**CFG)).client_store
    ids = torch.tensor([0, 5, -1, -1, 3, -1], dtype=torch.int32)
    dec = ttree.gaussians.slice_rows(ids.clamp_min(0))
    new = tpipe._apply_payload(store, ids, dec)
    written = torch.zeros(ttree.n_pad, dtype=torch.bool)
    written[[0, 3, 5]] = True
    for f in ("mu", "log_scale", "quat", "opacity", "sh"):
        a, tree_rows, old = (getattr(new, f), getattr(ttree.gaussians, f),
                             getattr(store, f))
        assert torch.equal(a[written], tree_rows[written]), f
        assert torch.equal(a[~written], old[~written]), f
    assert not torch.equal(store.mu[0], ttree.gaussians.mu[0])  # row 0 really changed


def test_fit_codec_and_wire_format(setup):
    tree, ttree, *_ = setup
    jc = jcomp.fit_codec(tree.gaussians, k_codes=64, iters=6)
    tc = tcomp.fit_codec(ttree.gaussians, k_codes=64, iters=6)
    assert_close(tc.codebook, jc.codebook, 1e-5, 1e-5)
    for f in ("pos_lo", "pos_hi", "scale_lo", "scale_hi"):
        assert_equal(getattr(tc, f), getattr(jc, f), f)
    assert tcomp.wire_bytes_per_gaussian(tc) == jcomp.wire_bytes_per_gaussian(jc)
    carried = to_torch_codec(jc)  # the JAX codec, carried across through numpy
    assert_equal(carried.codebook, jc.codebook)
    assert carried.code_bytes() == jc.code_bytes()
    x = torch.randn(50, tc.codebook.shape[1], generator=torch.Generator().manual_seed(0))
    assert_equal(vq_assign_plain(x, tc.codebook),
                 jcomp.vq_assign_ref(x.numpy(), np.asarray(tc.codebook)))
    _, jbpg = jpipe.session_wire_format(tree, jpipe.SessionConfig())
    _, tbpg = tpipe.session_wire_format(ttree, tpipe.SessionConfig())
    assert tbpg == jbpg  # compressed format: 16-bit attrs + fp16 DC + code


def test_compressed_sync_is_not_ported_and_default_device_raises(setup):
    """The default `SessionConfig()` (compressed wire) syncs; the default
    device is the card, and without one the session raises."""
    _tree, ttree, rig0, rigs = setup
    sess = tpipe.CollaborativeSession(ttree, tpipe.SessionConfig(), to_torch_rig(rig0),
                                      device=CPU)
    st, _ = sess.step(to_torch_rig(rigs[0]), render=False)
    assert st.synced and st.delta_size > 0
    assert sess.bytes_per_g == tcomp.wire_bytes_per_gaussian(sess.codec) == 29
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tpipe.CollaborativeSession(ttree, tpipe.SessionConfig(**CFG),
                                       to_torch_rig(rig0))


def test_compressed_session_exact_over_frames(setup):
    """The default compressed wire: per-frame stats exact, the client store
    within the decode tolerance, images within the raw session's tolerance,
    given the JAX session's codec."""
    tree, ttree, rig0, rigs = setup
    cfg = dict(CFG, use_compression=True)
    js = jpipe.CollaborativeSession(tree, jpipe.SessionConfig(**cfg), rig0)
    ts = tpipe.CollaborativeSession(ttree, tpipe.SessionConfig(**cfg), to_torch_rig(rig0),
                                    device=CPU)
    ts.codec = to_torch_codec(js.codec)
    assert ts.bytes_per_g == js.bytes_per_g == 29.0
    for rig in rigs:
        jst, jout = js.step(rig, render=True)
        tst, tout = ts.step(to_torch_rig(rig), render=True)
        assert dataclasses.asdict(tst) == dataclasses.asdict(jst), tst.frame
        assert_equal(ts.state.cut_gids, js.state.cut_gids)
        for f in ("mu", "log_scale", "quat", "opacity", "sh"):
            assert_close(getattr(ts.client_store, f), getattr(js.client_store, f),
                         1e-6, 1e-6, f)
        assert_close(tout[0], jout[0], 1e-4, 1e-5)
        assert_close(tout[1], jout[1], 1e-4, 1e-5)
    assert ts.sync_index == 3


def test_current_cut_ids_and_render_match_jax(setup):
    """`current_cut_ids` (None before the first sync) equals the JAX
    session's ids exactly, every id it lists is in the client store, and
    `render(rig, gids)` (−1 ids at opacity 0) equals `render_stereo` on that
    queue and the JAX session's `render` within the session test's
    tolerance, its stats exactly (as `tests/test_pipeline.py` reads them)."""
    tree, ttree, rig0, rigs = setup
    cfg = dict(CFG, w=1, w_star=16, use_compression=True)
    js = jpipe.CollaborativeSession(tree, jpipe.SessionConfig(**cfg), rig0)
    ts = tpipe.CollaborativeSession(ttree, tpipe.SessionConfig(**cfg), to_torch_rig(rig0),
                                    device=CPU)
    ts.codec = to_torch_codec(js.codec)
    assert ts.current_cut_ids is None and js.current_cut_ids is None
    for rig in rigs[:3]:
        js.step(rig, render=False)
        ts.step(to_torch_rig(rig), render=False)
        gids = ts.current_cut_ids
        assert gids.dtype == torch.int32
        assert_equal(gids, js.current_cut_ids)
        valid = gids[gids >= 0].long()
        assert bool(ts.client.has[valid].all())
    rig = rigs[2]
    tl, tr, (_s, _ll, _rl, tstats) = ts.render(to_torch_rig(rig), gids)
    queue = tpipe._render_queue(ts.client_store, gids)
    assert bool((queue.opacity[gids < 0] == 0).all()) and bool((gids < 0).any())
    rl, rr, (_s2, _l2, _r2, rstats) = tpipe.render_stereo(
        queue, to_torch_rig(rig), tile=ts.cfg.tile, list_len=ts.cfg.list_len,
        max_pairs=ts.cfg.max_pairs)
    assert torch.equal(tl, rl) and torch.equal(tr, rr)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(rstats)
    jl, jr, (_js, _jll, _jrl, jstats) = js.render(rig, js.current_cut_ids)
    assert_close(tl, jl, 1e-4, 1e-5)
    assert_close(tr, jr, 1e-4, 1e-5)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert float(tl.max()) > 0


SAT_CFG = dict(tau=32.0, w=2, w_star=2, cut_budget=2048, tile=16, list_len=256,
               max_pairs=1 << 16, use_compression=False)


@pytest.fixture(scope="module")
def saturating():
    """A tree over `saturating_scene` and a short walk: many left tiles
    stop before the end of their lists."""
    leaves = Gaussians(**{k: jnp.asarray(v)
                          for k, v in saturating_scene(60, 1000, 3).items()})
    tree = build_lod_tree(leaves, target_subtrees=16, seed=0)
    rigs = [StereoRig(left=make_camera([33.0 + 0.3 * i, 33.0, 1.7], [40, 40, 1.5],
                                       focal_px=200.0, width=96, height=64, near=0.2),
                      baseline=0.06) for i in range(5)]
    return tree, to_torch_tree(tree), rigs


def test_session_stats_exact_where_tiles_saturate(saturating):
    """Where left tiles stop early, the session's StepStats still equal the
    JAX session's, `right_alpha_skipped` included: the port's raster stage
    flags the entries after a stop as the reference's default path does
    (which has no stop). The fixture is checked to stop tiles, and to give
    another `right_alpha_skipped` under the Pallas contract's flags."""
    tree, ttree, rigs = saturating
    js = jpipe.CollaborativeSession(tree, jpipe.SessionConfig(**SAT_CFG), rigs[0])
    ts = tpipe.CollaborativeSession(ttree, tpipe.SessionConfig(**SAT_CFG),
                                    to_torch_rig(rigs[0]), device=CPU)
    plans = []

    def keep_plan(plan, cfg):
        plans.append(plan)
        return stage(plan, cfg)

    stage = tstages.rasterize
    stopped = pallas_differs = 0
    with mock.patch.object(tstages, "rasterize", keep_plan):
        for rig in rigs:
            jst, jout = js.step(rig, render=True)
            tst, tout = ts.step(to_torch_rig(rig), render=True)
            assert dataclasses.asdict(tst) == dataclasses.asdict(jst), tst.frame
            assert dataclasses.asdict(tout[2][3]) == dataclasses.asdict(jout[2][3])
            assert_close(tout[0], jout[0], 1e-4, 1e-5)
            assert_close(tout[1], jout[1], 1e-4, 1e-5)
            plan = plans[-1]
            ent, counts = traster.gather_entries(plan.left, plan.splats, "left")
            origins = traster.tile_origins(ent.shape[0], plan.left.tiles_x, 16, CPU)
            _, hits, done = traster.rasterize_slabs_plain(ent, counts, origins, tile=16,
                                                          with_processed=True)
            stopped += int((done < counts.clamp(0, ent.shape[1])).sum())
            pallas = alpha_skip_stats(plan.left, plan.right, hits, plan.splats)
            pallas_differs += pallas.right_alpha_skipped != tout[2][3].right_alpha_skipped
    assert stopped > 0 and pallas_differs > 0, (stopped, pallas_differs)
