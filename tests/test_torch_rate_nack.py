"""Port parity for the closed-loop bitrate controller and the NACK path
(`repro_torch.serve.lod_service.rate_control_step`, bandwidth tiers,
`delta_path.page_checksums` / `lost_row_mask`, `LodService.nack`) against
the JAX package (mirrors `tests/test_delta_path.py`'s rate-control and
page-integrity tests).

The controller feeds float32 bytes back into state: one ulp of difference
would change an allowance and, from then on, which pages ship. So the
mixed-tier fleet holds the allowance, the τ scale and `sync_bytes` bit for
bit every sync; the NACK loop drops the same seeded pages on both packages
and converges to the same store."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_states_equal, np_, to_torch_codec,
                           to_torch_tree)

from repro.core.pipeline import SessionConfig as JConfig
from repro.serve import delta_path as jdp
from repro.serve import lod_service as jsvc
from repro_torch.core.pipeline import SessionConfig as TConfig
from repro_torch.serve import delta_path as tdp
from repro_torch.serve import lod_service as tsvc

FOCAL = 1400.0
TAU = 32.0
GAUSS_FIELDS = ("mu", "log_scale", "quat", "opacity", "sh")


@pytest.fixture(scope="module")
def tsmall(small_tree):
    return to_torch_tree(small_tree)


def _pair(jtree, ttree, n, **kw):
    jcfg = JConfig(tau=TAU, cut_budget=8192)
    js = jsvc.LodService(jtree, jcfg, n, focal=FOCAL, dedup=True, **kw)
    ts = tsvc.LodService(ttree, TConfig(**dataclasses.asdict(jcfg)), n, focal=FOCAL,
                         dedup=True, device=CPU, **kw)
    ts.codec = to_torch_codec(js.codec)
    return js, ts


def _store_scatter(store, ids, dec):
    sel = np_(ids) >= 0
    gids = np_(ids)[sel]
    for f in GAUSS_FIELDS:
        store.setdefault(f, {})
        for g, row in zip(gids.tolist(), np_(getattr(dec, f))[sel]):
            store[f][g] = row
    return store


# -- the controller's update rule -----------------------------------------------------


def test_rate_control_step_matches_jax_on_seeded_arrays():
    """Random targets (some uncontrolled), measurements (some idle: 0
    bytes), allowances (some -1) and τ scales, over several page/budget
    pairs, page > budget included: the same arrays, dtypes included."""
    rng = np.random.default_rng(0)
    for page, max_rows in ((64, 4096), (256, 1024), (512, 128), (1, 1)):
        for _ in range(20):
            n = 16
            target = np.where(rng.random(n) < 0.2, np.inf, rng.uniform(1e3, 1e6, n))
            measured = np.where(rng.random(n) < 0.2, 0.0, rng.uniform(0, 2e6, n))
            allow = np.where(rng.random(n) < 0.1, -1, rng.integers(1, 8192, n))
            tau = rng.uniform(1.0, 8.0, n).astype(np.float32)
            got = tsvc.rate_control_step(target, measured, allow, tau, page_size=page,
                                         max_rows=max_rows)
            want = jsvc.rate_control_step(target, measured, allow, tau, page_size=page,
                                          max_rows=max_rows)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_rate_control_step_unit_and_idle_client():
    """The pinned cases of the reference: the clipped halving, τ escalation
    only at the floor, the doubling and decay, an idle client released, and
    the floor at min(page, budget)."""
    target = np.asarray([1e4, 1e4, np.inf, 1e4])
    allow, tau = tsvc.rate_control_step(target, [4e4, 4e4, 123.0, 1e4],
                                        np.asarray([1000, 64, -1, 1000]),
                                        np.ones(4, np.float32), page_size=64,
                                        max_rows=4096)
    assert allow.tolist() == [500, 64, -1, 1000]
    assert tau[0] == 1.0 and tau[1] == pytest.approx(1.25) and tau[2] == tau[3] == 1.0
    allow, tau = tsvc.rate_control_step(target, [1e3, 1e3, 0.0, 1e3], allow, tau,
                                        page_size=64, max_rows=4096)
    assert allow.tolist() == [1000, 128, -1, 2000] and tau[1] == 1.0
    allow, tau = np.asarray([64]), np.asarray([2.0], np.float32)
    allow, tau = tsvc.rate_control_step([1e4], [8e4], allow, tau, page_size=64,
                                        max_rows=4096)
    assert allow.tolist() == [64] and tau[0] == pytest.approx(2.5)
    allow, tau = tsvc.rate_control_step([1e4], [0.0], allow, tau, page_size=64,
                                        max_rows=4096)
    assert allow.tolist() == [128] and tau[0] == pytest.approx(2.0)
    for _ in range(8):
        allow, tau = tsvc.rate_control_step([1e4], [0.0], allow, tau, page_size=64,
                                            max_rows=4096)
    assert tau[0] == 1.0 and allow[0] == 4096
    allow, tau = tsvc.rate_control_step([1e4], [4e4], [64], np.ones(1, np.float32),
                                        page_size=512, max_rows=128)
    assert allow.tolist() == [128] and tau[0] == pytest.approx(1.25)


def test_page_size_budget_degenerate_config(small_tree, tsmall):
    cfg = TConfig(tau=TAU, cut_budget=8192)
    for page in (256, 0):
        with pytest.raises(ValueError, match="page_size"):
            tsvc.LodService(tsmall, cfg, 1, focal=FOCAL, delta_budget=64,
                            page_size=page, device=CPU)
    assert tsvc.LodService(tsmall, cfg, 1, focal=FOCAL, delta_budget=64,
                           device=CPU).page_size == 64
    with pytest.raises(ValueError, match="unknown bandwidth tier"):
        tsvc.LodService(tsmall, cfg, 1, focal=FOCAL, bandwidth="modem", device=CPU)


# -- mixed bandwidth tiers -----------------------------------------------------------


def test_mixed_bandwidth_tiers_match_jax_every_sync(small_tree, tsmall):
    """Four clients on a narrow numeric target, the phone tier, a tier set
    mid-run and no control, with small pages, over 8 moving syncs and then
    static ones until every debt drains: each sync the port's stats (bytes
    bit for bit), state, and every client's (target, allowance, τ scale)
    equal JAX's. The narrow client is paced below the wide one, its τ scale
    escalates, and nothing is lost."""
    bw = [2e3, "phone", None, 1e9]
    js, ts = _pair(small_tree, tsmall, 4, bandwidth=bw, page_size=64)
    assert ts.client_bandwidth(1)[0] == tsvc.BANDWIDTH_TIERS["phone"]
    assert ts.client_bandwidth(2) == js.client_bandwidth(2) == (np.inf, None, 1.0)
    rng = np.random.default_rng(17)
    cams = np.asarray([[40.0, 40.0, 2.0], [41.0, 40.5, 2.2], [38.0, 44.0, 2.0],
                       [44.0, 38.0, 2.5]], np.float32)
    trace = []
    for t in range(8):
        if t == 3:
            ts.set_bandwidth(2, "headset")
            js.set_bandwidth(2, "headset")
        tst, jst = ts.sync(cams), js.sync(cams)
        assert_states_equal(tst, jst, f"sync {t}")
        assert_states_equal(ts.state, js.state, f"sync {t}")
        for cid in range(4):
            assert ts.client_bandwidth(cid) == js.client_bandwidth(cid), (t, cid)
        trace.append((np_(tst.sync_bytes).copy(), np_(tst.delta_deferred).copy(),
                      ts.client_bandwidth(0)))
        cams = cams + rng.uniform(1.0, 3.0, cams.shape).astype(np.float32)
    assert trace[0][0][0] < trace[0][0][3]
    assert sum(int(d[0] > 0) for _b, d, _c in trace) > 0
    assert max(c[2] for _b, _d, c in trace) > 1.0
    for t in range(64):
        tst, jst = ts.sync(cams), js.sync(cams)
        assert_states_equal(tst, jst, f"drain {t}")
        if not ts.state.pending.any():
            break
    assert not ts.state.pending.any() and not np.asarray(js.state.pending).any()
    assert_states_equal(ts.state, js.state, "drained")
    cid = ts.admit(cams[0], bandwidth="tethered")
    assert cid == js.admit(cams[0], bandwidth="tethered")
    assert ts.client_bandwidth(cid) == js.client_bandwidth(cid)
    ts.evict(0)
    js.evict(0)
    tst, jst = ts.sync(), js.sync()
    assert_states_equal(tst, jst, "after churn")
    for c in ts.active_ids:
        assert ts.client_bandwidth(c) == js.client_bandwidth(c)


def test_partial_syncs_commit_only_fresh_measurements(small_tree, tsmall):
    """Under partial syncs a sat-out client's controller does not step on
    its older measurement again: the allowances follow JAX's sync by sync."""
    js, ts = _pair(small_tree, tsmall, 3, bandwidth=[3e3, 6e3, 1e4], page_size=32)
    rng = np.random.default_rng(2)
    cams = np.asarray([[40.0, 40.0, 2.0], [42.0, 41.0, 2.0], [39.0, 43.0, 2.3]],
                      np.float32)
    for t in range(6):
        part = [c for c in range(3) if (t + c) % 3 != 0]
        moves = {c: cams[c] + t for c in part}
        tst, jst = ts.sync(moves, participate=part), js.sync(moves, participate=part)
        assert_states_equal(tst, jst, f"sync {t}")
        np.testing.assert_array_equal(ts._stats_fresh, js._stats_fresh)
        np.testing.assert_array_equal(ts._allowance, js._allowance)
        np.testing.assert_array_equal(ts._tau_scale, js._tau_scale)
    assert_states_equal(ts.state, js.state, "end")


# -- page checksums and NACK ---------------------------------------------------------


def _paged_pair(small_tree, tsmall):
    js, ts = _pair(small_tree, tsmall, 2, delta_budget=128, page_size=32)
    cams = np.asarray([[40.0, 40.0, 2.0], [46.0, 41.0, 2.5]], np.float32)
    ts.sync(cams)
    js.sync(cams)
    return js, ts


def test_page_checksums_equal_jax_and_flip_on_damage(small_tree, tsmall):
    """The checksums of a paged stream equal JAX's (uint32), equal a
    receiver's re-derivation in any order, and flip on a dropped row (its
    page) and on a row moved between pages (both)."""
    js, ts = _paged_pair(small_tree, tsmall)
    batch = ts.last_delta
    want = js.delta_checksums()
    got = ts.delta_checksums()
    assert got.dtype == want.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    row_page, gids = np_(batch.row_page), np_(batch.union_gids)
    n_pages = int(batch.pages)
    assert n_pages > 1
    shipped = row_page >= 0
    rederived = np.zeros_like(got)
    for i in np.random.default_rng(0).permutation(np.flatnonzero(shipped)):
        with np.errstate(over="ignore"):
            rederived[row_page[i]] += np.uint32(gids[i]) * tdp._CKSUM_MIX + np.uint32(1)
    np.testing.assert_array_equal(rederived, got)
    drop = int(np.flatnonzero(shipped)[0])
    mangled = row_page.copy()
    mangled[drop] = -1
    diff = tdp.page_checksums(dataclasses.replace(
        batch, row_page=torch.from_numpy(mangled))) != got
    assert diff[row_page[drop]] and diff.sum() == 1
    src, dst = int(row_page[drop]), (int(row_page[drop]) + 1) % n_pages
    moved = row_page.copy()
    moved[drop] = dst
    diff2 = tdp.page_checksums(dataclasses.replace(
        batch, row_page=torch.from_numpy(moved))) != got
    assert diff2[src] and diff2[dst] and diff2.sum() == 2
    # the gid mix wraps: a large gid goes through uint32 arithmetic
    big = dataclasses.replace(batch, union_gids=torch.where(
        batch.union_gids >= 0, batch.union_gids + (1 << 30), batch.union_gids))
    jbig = dataclasses.replace(js.last_delta, union_gids=np.where(
        np.asarray(js.last_delta.union_gids) >= 0,
        np.asarray(js.last_delta.union_gids) + (1 << 30),
        np.asarray(js.last_delta.union_gids)))
    np.testing.assert_array_equal(tdp.page_checksums(big), jdp.page_checksums(jbig))


def test_lost_row_mask_equals_jax(small_tree, tsmall):
    js, ts = _paged_pair(small_tree, tsmall)
    n_pages = int(ts.last_delta.pages)
    for slot in (0, 1):
        for lost in ([0], [0, n_pages - 1], range(n_pages), []):
            got = tdp.lost_row_mask(ts.last_delta, slot, lost)
            want = jdp.lost_row_mask(js.last_delta, slot, lost)
            assert got.dtype == want.dtype == bool
            np.testing.assert_array_equal(got, want, err_msg=f"slot {slot} {list(lost)}")
        np.testing.assert_array_equal(
            tdp.lost_row_mask(ts.last_delta, slot, range(n_pages)),
            np_(ts.last_delta.delivered[slot]))
    np.testing.assert_array_equal(ts.resolve_nack(1, [1, 0]), js.resolve_nack(1, [1, 0]))
    with pytest.raises(ValueError, match="outside"):
        ts.resolve_nack(0, [n_pages])
    with pytest.raises(ValueError, match="NACK gids"):
        ts.nack_rows(0, [ts.tree.n_pad])


def test_nack_racing_an_evict_brings_no_debt_back(small_tree, tsmall):
    """A NACK applied to a slot after its client left queues nothing."""
    js, ts = _paged_pair(small_tree, tsmall)
    rows = np.flatnonzero(tdp.lost_row_mask(ts.last_delta, 1, [0]))
    assert rows.size
    slot = ts._slot_of(1)
    ts.evict(1)
    state = tsvc.service_nack_rows(ts.state, slot, np.isin(np.arange(ts.tree.n_pad),
                                                           rows))
    assert not state.pending[slot].any()
    with pytest.raises(KeyError):
        ts.nack(1, [0])


def test_nack_retransmit_converges_under_seeded_loss(small_tree, tsmall):
    """Each sync, every page of the paged stream is lost with probability
    0.1 (one seeded draw, applied to both packages): the client keeps the
    intact pages and NACKs the rest. Every sync's stats and state equal
    JAX's, and the accumulated store converges bit for bit to the lossless
    unbudgeted service's."""
    cams = np.asarray([[40.0, 40.0, 2.0], [44.0, 43.0, 2.5]], np.float32)
    jbase, base = _pair(small_tree, tsmall, 2)
    base.sync(cams)
    want = _store_scatter({}, *base.client_delta(0))
    js, ts = _pair(small_tree, tsmall, 2, delta_budget=128, page_size=32)
    ts.codec = base.codec
    rng = np.random.default_rng(23)
    got, losses = {}, 0
    for sync in range(64):
        tst, jst = ts.sync(cams), js.sync(cams)
        assert_states_equal(tst, jst, f"sync {sync}")
        n_pages = int(ts.last_delta.pages)
        lost = [p for p in range(n_pages) if rng.random() < 0.10]
        losses += len(lost)
        ids, dec = ts.client_delta(0)
        keep = np_(ids) >= 0
        if lost:
            keep &= ~np.isin(np_(ts.last_delta.row_page), lost)
        got = _store_scatter(got, np.where(keep, np_(ids), -1), dec)
        if lost:
            assert ts.nack(0, lost) == js.nack(0, lost)
        assert_states_equal(ts.state, js.state, f"sync {sync} after NACK")
        if not ts.state.pending.any() and not lost:
            break
    assert losses > 0, "the seed never dropped a page"
    assert not ts.state.pending.any()
    for f in want:
        assert got[f].keys() == want[f].keys(), f
        for g in want[f]:
            np.testing.assert_array_equal(got[f][g], want[f][g], err_msg=f"{f}/gid {g}")
