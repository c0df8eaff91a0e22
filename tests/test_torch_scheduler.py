"""Port parity for partial-fleet syncs and the deadline scheduler
(`repro_torch.serve.scheduler`) against the JAX package (mirrors
`tests/test_scheduler.py`, without its mesh subprocess; its recovery test
is mirrored in `tests/test_torch_recovery.py`).

A sync that selects every live slot replays the lockstep sync bitwise;
slots that sit out keep their state bitwise and report zero rows; bad
participation raises before anything changes; the array and dict camera
forms agree after churn; scheduler ticks on an injected clock select, stamp
and refit exactly as JAX's `DeadlineScheduler` does on the same clock; the
cost model, predicted-cost admission, `state_dict` and the workload
generators equal JAX's."""

import dataclasses
import json

import numpy as np
import pytest

from _torch_parity import (CPU, assert_states_equal, np_, state_arrays, to_torch_codec,
                           to_torch_tree)

from repro.core import lod_search as jls
from repro.core.pipeline import SessionConfig as JConfig
from repro.serve import lod_service as jsvc
from repro.serve import scheduler as jsch
from repro_torch.core import lod_search as tls
from repro_torch.core.pipeline import SessionConfig as TConfig
from repro_torch.serve import lod_service as tsvc
from repro_torch.serve import scheduler as tsch

FOCAL = 1400.0
TAU = 32.0


@pytest.fixture(scope="module")
def ttiny(tiny_tree):
    return to_torch_tree(tiny_tree)


def _mk(jtree, ttree, n, mode="pooled", **kw):
    """The JAX service (pooled) and the port's, on the JAX codec."""
    jcfg = JConfig(tau=TAU, cut_budget=2048)
    js = jsvc.LodService(jtree, jcfg, n, focal=FOCAL, dedup=True, mode="pooled", **kw)
    ts = tsvc.LodService(ttree, TConfig(**dataclasses.asdict(jcfg)), n, focal=FOCAL,
                         dedup=True, mode=mode, device=CPU, **kw)
    ts.codec = to_torch_codec(js.codec)
    return js, ts


def _port(ttree, n, mode="pooled", codec=None, **kw):
    ts = tsvc.LodService(ttree, TConfig(tau=TAU, cut_budget=2048), n, focal=FOCAL,
                         dedup=True, mode=mode, device=CPU, **kw)
    if codec is not None:
        ts.codec = codec
    return ts


def _cams(rng, n):
    return rng.uniform([2, 2, 1], [28, 28, 6], (n, 3)).astype(np.float32)


class _Clock:
    """Scripted monotonic clock: +1 ms a read."""

    def __init__(self, t0: float = 100.0, step: float = 1e-3):
        self.t, self.step = float(t0), float(step)

    def __call__(self) -> float:
        self.t += self.step
        return self.t


# -- partial-fleet syncs -----------------------------------------------------------


@pytest.mark.parametrize("mode", ["vmapped", "pooled"])
def test_participate_everyone_replays_lockstep_bitwise(tiny_tree, ttiny, mode):
    """A sync selecting every live slot (by ids, then by a bool mask) equals
    the lockstep sync: stats and state, and both equal JAX's."""
    js, a = _mk(tiny_tree, ttiny, 4, mode=mode)
    b = _port(ttiny, 4, mode=mode, codec=a.codec)
    rng = np.random.default_rng(3)
    pos = _cams(rng, 4)
    for t in range(3):
        part = b.active_ids if t % 2 == 0 else np.ones(b.capacity, bool)
        sa, sb, sj = a.sync(pos), b.sync(pos, participate=part), js.sync(pos)
        assert_states_equal(sb, sj, f"{mode} stats {t}")
        assert_states_equal(b.state, js.state, f"{mode} state {t}")
        assert_states_equal(a.state, js.state, f"{mode} lockstep state {t}")
        assert_states_equal(sa, sj, f"{mode} lockstep stats {t}")
        pos = (pos + rng.normal(0, 2.5, (4, 3))).astype(np.float32)


@pytest.mark.parametrize("mode", ["vmapped", "pooled"])
def test_partial_tick_satout_slots_bitwise_untouched(tiny_tree, ttiny, mode):
    """On a ragged fleet, a tick of one client leaves every other slot's
    state bitwise as it was, its stats rows zero and only the participant's
    counter ticked; the controller's freshness mask marks the participant;
    the port equals JAX throughout."""
    js, ts = _mk(tiny_tree, ttiny, 5, mode=mode, capacity=8)
    rng = np.random.default_rng(7)
    c = _cams(rng, 5)
    ts.sync(c)
    js.sync(c)
    for s in (ts, js):
        s.evict(1)
        s.evict(3)
        s.sync()
    before = state_arrays(ts.state)
    slot0 = ts._slot_of(0)
    move = {0: np.asarray([25.0, 25.0, 4.0], np.float32)}
    tst, jst = ts.sync(move, participate=[0]), js.sync(move, participate=[0])
    assert_states_equal(tst, jst, "partial")
    assert_states_equal(ts.state, js.state, "partial")
    after = state_arrays(ts.state)
    others = [s for s in range(ts.capacity) if s != slot0]
    for k, x in after.items():
        if x.ndim >= 1 and x.shape[0] == ts.capacity:
            np.testing.assert_array_equal(x[others], before[k][others], err_msg=k)
        else:
            np.testing.assert_array_equal(x, before[k], err_msg=k)
    assert after["sync_index"][slot0] == before["sync_index"][slot0] + 1
    for f in ("cut_size", "delta_size", "sync_bytes", "resweeps", "nodes_touched",
              "unique_delta"):
        assert not np_(getattr(tst, f))[others].any(), f
    fresh = np.zeros(ts.capacity, bool)
    fresh[slot0] = True
    np.testing.assert_array_equal(ts._stats_fresh, fresh)
    np.testing.assert_array_equal(ts._stats_fresh, js._stats_fresh)


def test_bad_participation_raises_before_state_is_touched(ttiny):
    ts = _port(ttiny, 3)
    ts.sync(_cams(np.random.default_rng(0), 3))
    state = ts.state
    with pytest.raises(KeyError):
        ts.sync(participate=[99])
    with pytest.raises(ValueError):
        ts.sync(participate=np.ones(ts.capacity + 1, bool))
    cams_before = ts._slot_cams.copy()
    with pytest.raises(KeyError):
        ts.sync({0: [9.0, 9.0, 2.0], 99: [1.0, 1.0, 1.0]})
    np.testing.assert_array_equal(ts._slot_cams, cams_before)
    assert ts.state is state
    ts.sync({0: [9.0, 9.0, 2.0]})
    assert np.allclose(ts._slot_cams[ts._slot_of(0)], [9.0, 9.0, 2.0])


def test_sync_array_and_dict_forms_agree_on_churned_fleet(tiny_tree, ttiny):
    js, a = _mk(tiny_tree, ttiny, 6, capacity=8)
    b = _port(ttiny, 6, capacity=8, codec=a.codec)
    rng = np.random.default_rng(5)
    pos = _cams(rng, 6)
    for s in (a, b, js):
        s.sync(pos)
        s.evict(0)
        s.evict(4)
    ids = a.active_ids
    assert ids == b.active_ids == js.active_ids
    for t in range(2):
        cams = _cams(rng, len(ids))
        sa = a.sync(cams)
        sb = b.sync({cid: cams[k] for k, cid in enumerate(ids)})
        sj = js.sync(cams)
        assert_states_equal(sa, sj, f"array {t}")
        assert_states_equal(sb, sj, f"dict {t}")
        assert_states_equal(a.state, js.state, f"array {t}")
        assert_states_equal(b.state, js.state, f"dict {t}")
        np.testing.assert_array_equal(a._slot_cams, b._slot_cams)


def test_predicted_stale_counts_match_jax(tiny_tree, ttiny):
    """The read-only staleness preview equals JAX's and changes nothing."""
    js, ts = _mk(tiny_tree, ttiny, 4, capacity=4)
    rng = np.random.default_rng(9)
    c = _cams(rng, 4)
    ts.sync(c)
    js.sync(c)
    ts.evict(2)
    js.evict(2)
    probe = np.concatenate([_cams(rng, 2), np.zeros((1, 3), np.float32),
                            _cams(rng, 1)])
    taus = np.asarray([TAU, 40.0, TAU, 24.0], np.float32)
    before = state_arrays(ts.state)
    got = tls.predicted_stale_counts(ts.tree, ts.state.temporal, probe, ts.focal, taus,
                                     ts.state.fleet.active)
    want = jls.predicted_stale_counts(js.tree, js.state.temporal, probe, js.focal, taus,
                                      js.state.fleet.active)
    assert np_(got).dtype == np_(want).dtype == np.int32
    np.testing.assert_array_equal(np_(got), np_(want))
    assert int(got[2]) == 0 and int(got.sum()) > 0
    for k, x in state_arrays(ts.state).items():
        np.testing.assert_array_equal(x, before[k], err_msg=k)


# -- the scheduler ----------------------------------------------------------------


def _stamped(stats):
    return np_(stats.mtp_ms), np_(stats.deadline_miss)


def test_tick_matches_jax_on_injected_clock(tiny_tree, ttiny):
    """The same motion through the port's scheduler and JAX's, each on its
    own copy of one scripted clock: the same selections, the same stamped
    MTP and miss columns, the same stats and state after every tick, the
    same fitted cost model and summary."""
    js, ts = _mk(tiny_tree, ttiny, 4)
    rng = np.random.default_rng(2)
    c = _cams(rng, 4)
    ts.sync(c)
    js.sync(c)
    kw = dict(default_deadline_ms=4.0, tick_budget_ms=3.0,
              cost_model=None)
    tsched = tsch.DeadlineScheduler(ts, clock=_Clock(), **kw)
    jsched = jsch.DeadlineScheduler(js, clock=_Clock(), **kw)
    for s in (tsched, jsched):
        s.cost.alpha, s.cost.beta = 0.5, 0.25
        s.set_deadline(1, 2.5)
    motion = np.random.default_rng(4)
    for t in range(8):
        moved = [cid for cid in range(4) if motion.random() < 0.6]
        poses = {cid: _cams(motion, 1)[0] for cid in moved}
        for cid, p in poses.items():
            tsched.observe_motion(cid, p)
            jsched.observe_motion(cid, p)
        assert tsched.select() == jsched.select(), t
        tst, jst = tsched.tick(), jsched.tick()
        assert (tst is None) == (jst is None), t
        if tst is None:
            continue
        assert_states_equal(tst, jst, f"tick {t}")
        assert_states_equal(ts.state, js.state, f"tick {t}")
    assert tsched.stats_summary() == jsched.stats_summary()
    assert tsched.stats_summary()["n"] > 0
    assert tsched.cost.state_dict() == jsched.cost.state_dict()
    assert tsched.state_dict() == jsched.state_dict()


def test_tick_serves_only_unserved_motion_and_stamps_mtp(ttiny):
    ts = _port(ttiny, 4)
    ts.sync(_cams(np.random.default_rng(2), 4))
    sched = tsch.DeadlineScheduler(ts, default_deadline_ms=1e6, clock=_Clock())
    sched.observe_motion(0, [20.0, 20.0, 3.0])
    sched.observe_motion(2, [4.0, 22.0, 2.0])
    assert set(sched.select()) == {0, 2}
    mtp, miss = _stamped(sched.tick())
    served, others = [ts._slot_of(0), ts._slot_of(2)], [ts._slot_of(1), ts._slot_of(3)]
    assert (mtp[served] > 0.0).all() and not mtp[others].any() and not miss.any()
    assert sched.tick() is None
    sched.set_deadline(0, 1e-6)
    sched.observe_motion(0, [21.0, 21.0, 3.0])
    _mtp, miss = _stamped(sched.tick())
    assert bool(miss[ts._slot_of(0)]) and miss.sum() == 1
    s = sched.stats_summary()
    assert s["n"] == 3 and 0.0 < s["deadline_miss_rate"] < 1.0
    assert s["mtp_p99_ms"] >= s["mtp_p50_ms"] > 0.0


def test_select_edf_orders_by_slack_and_budget_never_starves_head(ttiny):
    ts = _port(ttiny, 3)
    ts.sync(np.tile(np.asarray([10.0, 10.0, 2.0], np.float32), (3, 1)))
    sched = tsch.DeadlineScheduler(ts, default_deadline_ms=1000.0, clock=_Clock())
    sched.set_deadline(1, 10.0)
    for cid in (0, 1, 2):
        sched.observe_motion(cid, [25.0 - cid, 3.0 + cid, 5.0])
    sel = sched.select()
    assert sel[0] == 1 and set(sel) == {0, 1, 2}
    sched.cost.alpha, sched.cost.beta = 0.0, 1.0
    sched.tick_budget_ms = 1.0
    assert sched.select() == [1]
    stats = sched.tick()
    assert int(stats.resweeps[ts._slot_of(1)]) > 0
    sched.tick_budget_ms = None
    assert set(sched.select()) == {0, 2}


def test_cost_model_refit_matches_jax():
    """The least-squares refit, the alpha-only window and the degenerate
    fit, each equal to JAX's model on the same samples."""
    cases = [(dict(alpha_ms=50.0, beta_ms=5.0, min_samples=6),
              [(p, 3.0 + 0.25 * p) for p in (0, 2, 4, 8, 16, 32, 64)]),
             (dict(alpha_ms=1.0, beta_ms=0.5, min_samples=2), [(4, 7.0)] * 4),
             (dict(min_samples=2), [(0, 10.0), (10, 1.0), (20, 0.5)])]
    for kw, samples in cases:
        t, j = tsch.CostModel(**kw), jsch.CostModel(**kw)
        for p, ms in samples:
            t.observe(p, ms)
            j.observe(p, ms)
        assert t.state_dict() == j.state_dict()
        assert t.predict(100) == j.predict(100)
    cm = tsch.CostModel(alpha_ms=50.0, beta_ms=5.0, min_samples=6)
    for pairs in (0, 2, 4, 8, 16, 32, 64):
        cm.observe(pairs, 3.0 + 0.25 * pairs)
    assert cm.alpha == pytest.approx(3.0, abs=1e-6)
    assert cm.beta == pytest.approx(0.25, abs=1e-6)


def test_predicted_cost_admission_denial_leaves_service_untouched(ttiny):
    ts = _port(ttiny, 2, capacity=4)
    ts.sync(_cams(np.random.default_rng(4), 2))
    sched = tsch.DeadlineScheduler(ts, default_deadline_ms=50.0, clock=_Clock())
    sched.cost.alpha, sched.cost.beta = 1000.0, 0.0
    state = ts.state
    with pytest.raises(tsvc.AdmissionDenied, match="cold first sync"):
        sched.admit([5.0, 5.0, 2.0])
    assert sched.admit([5.0, 5.0, 2.0], required=False) is None
    assert ts.n_clients == 2 and ts.state is state
    sched.cost.alpha, sched.cost.beta = 0.0, 1.0
    d = 2.0 * sched._ns
    for cid in ts.active_ids:
        sched.set_deadline(cid, d)
    with pytest.raises(tsvc.AdmissionDenied, match="utilization"):
        sched.admit([5.0, 5.0, 2.0], deadline_ms=d)
    with pytest.raises(tsvc.AdmissionDenied, match="not positive"):
        sched.admit([5.0, 5.0, 2.0], deadline_ms=0.0)
    sched.cost.beta = 0.001
    cid = sched.admit([5.0, 5.0, 2.0], deadline_ms=40.0)
    assert ts.n_clients == 3 and sched.deadline(cid) == 40.0
    assert cid in sched.select()
    sched.evict(cid)
    assert cid not in sched._clients and ts.n_clients == 2


def test_scheduler_state_dict_json_roundtrip(ttiny):
    ts = _port(ttiny, 2)
    ts.sync(_cams(np.random.default_rng(6), 2))
    sched = tsch.DeadlineScheduler(ts, default_deadline_ms=25.0, tick_budget_ms=12.0,
                                   clock=_Clock())
    sched.set_deadline(1, 75.0)
    sched.observe_motion(0, [20.0, 20.0, 3.0])
    sched.observe_motion(0, [21.0, 20.0, 3.0])
    sched.tick()
    blob = json.dumps(sched.state_dict())
    other = _port(ttiny, 2, codec=ts.codec)
    other.sync(_cams(np.random.default_rng(6), 2))
    sched2 = tsch.DeadlineScheduler(other, clock=_Clock())
    sched2.load_state_dict(json.loads(blob))
    assert sched2.default_deadline_ms == 25.0 and sched2.tick_budget_ms == 12.0
    assert sched2.deadline(1) == 75.0
    assert sched2.cost.alpha == sched.cost.alpha and sched2.cost.beta == sched.cost.beta
    for cid in (0, 1):
        a, b = sched._clients[cid], sched2._clients[cid]
        assert b.velocity == a.velocity and b.ewma_pairs == a.ewma_pairs
    assert sched._clients[0].velocity > 0.0
    assert sched2.state_dict() == json.loads(blob)


def test_workload_generators_equal_jax():
    """Same seed, same arrays as JAX's generators, and the documented
    shapes."""
    for seed in (0, 5):
        np.testing.assert_array_equal(
            tsch.poisson_arrivals(np.random.default_rng(seed), 2.0, 256),
            jsch.poisson_arrivals(np.random.default_rng(seed), 2.0, 256))
        for kw in (dict(speed=0.5, burst_prob=0.0), dict(speed=0.5, burst_prob=0.5,
                                                        burst_scale=10.0),
                   dict(start=[3.0, 4.0, 1.5])):
            np.testing.assert_array_equal(
                tsch.bursty_motion_path(np.random.default_rng(seed), 128, **kw),
                jsch.bursty_motion_path(np.random.default_rng(seed), 128, **kw))
        for kw in (dict(teleport_every=5, extent=30.0), dict(start=[1.0, 2.0, 3.0])):
            np.testing.assert_array_equal(
                tsch.straggler_path(np.random.default_rng(seed), 200, **kw),
                jsch.straggler_path(np.random.default_rng(seed), 200, **kw))
    a = tsch.poisson_arrivals(np.random.default_rng(0), 2.0, 256)
    assert a.shape == (256,) and a.dtype == np.int64 and 1.5 < a.mean() < 2.5
    calm = tsch.bursty_motion_path(np.random.default_rng(1), 128, speed=0.5,
                                   burst_prob=0.0)
    assert calm.shape == (128, 3) and calm.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(np.diff(calm, axis=0), axis=1), 0.5,
                               rtol=1e-5)
    strag = tsch.straggler_path(np.random.default_rng(2), 200, teleport_every=5,
                                extent=30.0)
    jumps = np.linalg.norm(np.diff(strag, axis=0), axis=1)
    assert np.abs(strag).max() <= 30.0
    assert (jumps == 0.0).mean() > 0.5 and (jumps > 5.0).sum() >= 10
