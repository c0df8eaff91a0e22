"""Port parity: LoD search (top sweep, K1's plain slab sweep, temporal
search) of `repro_torch` against the JAX package and its numpy oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, assert_close, assert_equal, np_, to_torch_tree

from repro.core import lod_search as jls
from repro.kernels import ops as kops
from repro_torch import kernels as tkernels
from repro_torch.core import camera as tcam
from repro_torch.core import lod_search as tls
from repro_torch.kernels import lod_cut as tlod

FOCAL = 1400.0


@pytest.fixture(scope="module")
def trees(small_tree, tiny_tree):
    return {"small": (small_tree, to_torch_tree(small_tree)),
            "tiny": (tiny_tree, to_torch_tree(tiny_tree))}


@pytest.mark.parametrize("which,tau,cam", [
    ("small", 16.0, [20, 20, 1.7]), ("small", 64.0, [250, 250, 120]),
    ("small", 256.0, [-100, 50, 30]), ("tiny", 8.0, [0, 0, 5]),
    ("tiny", 64.0, [40, -30, 60])])
def test_full_search_exact(trees, which, tau, cam):
    jt, tt = trees[which]
    cam = np.asarray(cam, np.float32)
    jc, js = jls.full_search(jt, cam, jnp.float32(FOCAL), jnp.float32(tau))
    tc, ts = tls.full_search(tt, cam, FOCAL, tau)
    assert_equal(tc.mask(tt), jc.mask(jt))
    assert_equal(tc.mask(tt), jls.reference_search_np(jt, cam, FOCAL, tau))
    assert_equal(tc.root_expand, jc.root_expand)
    assert int(tc.nodes_touched) == int(jc.nodes_touched)
    assert_close(ts.rho, js.rho, 1e-6, 0.0)


def test_slab_sweep_plain_matches_pallas(trees):
    """K1's plain version against the reference's Pallas kernel (interpret
    mode) and its XLA sweep, on the same slabs and camera."""
    jt, tt = trees["small"]
    cam = np.array([250, 250, 120], np.float32)
    top_expand, _ = jls.top_sweep(jt, jnp.asarray(cam), jnp.float32(FOCAL),
                                  jnp.float32(64.0))
    rpe = top_expand[jt.slab_root_parent_top]
    cut_p, rexp_p, rho_p = kops.lod_slab_sweep(jt, jnp.asarray(cam), jnp.float32(FOCAL),
                                               jnp.float32(64.0), rpe, use_pallas=True)
    tkernels.reset_launch_counts()
    cut, rexp, rho = tlod.lod_slab_sweep(
        tt.slab_mu(), tt.slab_size(), tt.slab_parent, tt.slab_level, tt.slab_is_leaf,
        tt.slab_valid, torch.tensor(np_(rpe)), torch.from_numpy(cam), FOCAL, 64.0,
        max_depth=tt.meta.slab_max_depth)
    assert tkernels.launch_counts()["lod_slab_sweep"] == 0  # CPU: plain version
    assert_equal(cut, cut_p)
    assert_equal(rexp, rexp_p)
    assert_close(rho, rho_p, 1e-6, 0.0)


def test_all_invalid_slab_rho_is_inf(trees):
    """An all-invalid slab gets ρ = +inf, as `_slab_sweep_one` gives (the
    Pallas body writes 3.4e38 instead)."""
    _, tt = trees["tiny"]
    valid = tt.slab_valid.clone()
    valid[0] = False
    _, rexp, rho = tlod.slab_sweep_plain(
        tt.slab_mu(), tt.slab_size(), tt.slab_parent, tt.slab_level, tt.slab_is_leaf,
        valid, torch.ones(tt.meta.Ns, dtype=torch.bool), torch.zeros(3), FOCAL, 32.0,
        max_depth=tt.meta.slab_max_depth)
    assert torch.isinf(rho[0]) and rho[0] > 0 and not bool(rexp[0])
    assert torch.isfinite(rho[1:]).all()


@pytest.mark.parametrize("tau", [24.0, 48.0])
def test_temporal_search_walk_exact(trees, tau):
    """Over a street-level walk: cut masks, resweep, nodes_touched,
    root_expand and ρ against the JAX temporal search and the numpy oracle."""
    jt, tt = trees["small"]
    cams = [c.pos.numpy() for c in tcam.walk_trajectory(
        tcam.TrajectoryConfig(seed=1, speed_mps=30.0), 12, (104.0, 104.0),
        device=CPU)]
    js = jls.TemporalState.initial(jt.meta.Ns, jt.meta.S)
    ts = tls.TemporalState.initial(tt.meta.Ns, tt.meta.S, CPU)
    resweeps = []
    for cam in cams:
        jc, js = jls.temporal_search(jt, js, cam, jnp.float32(FOCAL), jnp.float32(tau))
        tc, ts = tls.temporal_search(tt, ts, cam, FOCAL, tau)
        assert_equal(tc.mask(tt), jc.mask(jt))
        assert_equal(tc.mask(tt), jls.reference_search_np(jt, cam, FOCAL, tau))
        assert_equal(tc.resweep, jc.resweep)
        assert_equal(tc.root_expand, jc.root_expand)
        assert int(tc.nodes_touched) == int(jc.nodes_touched)
        assert_close(ts.rho, js.rho, 1e-6, 0.0)
        assert_equal(ts.cam0, js.cam0)
        resweeps.append(int(tc.resweep.sum()))
    assert resweeps[0] == tt.meta.Ns and min(resweeps) < tt.meta.Ns


def test_cut_gids_and_pow2(trees):
    jt, tt = trees["small"]
    cam = np.array([250, 250, 120], np.float32)
    jc, _ = jls.full_search(jt, cam, jnp.float32(FOCAL), jnp.float32(64.0))
    tc, _ = tls.full_search(tt, cam, FOCAL, 64.0)
    n = int(tc.count())
    for budget in (n + 8, max(n - 5, 1)):
        jg, jn, jo = jls.cut_gids(jc, jt, budget)
        tg, tn, to = tls.cut_gids(tc, tt, budget)
        assert_equal(tg, jg)
        assert int(tn) == int(jn) and bool(to) == bool(jo)
        assert tg.dtype == torch.int32
    for n_, cap in [(0, 8), (1, 8), (5, 8), (9, 8), (1000, 4096)]:
        assert tls.pow2_bucket(n_, cap) == jls.pow2_bucket(n_, cap)
