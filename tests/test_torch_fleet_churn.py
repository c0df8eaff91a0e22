"""Port parity for the ragged fleet: admit, evict, capacity growth and shrink
of `repro_torch.serve.lod_service.LodService` against the JAX service on the
same schedules (mirrors `tests/test_fleet_churn.py`).

Integer and boolean outputs are held exactly and `sync_bytes` bit for bit:
every stats column, every state leaf, the client cuts and the decoded Δ
slices, sync by sync, under one admit/evict/grow script on both schedulers;
inactive slots are free and recycled slots fresh; growth follows the pow2
buckets; a shrink keeps the survivors' replay; a denied admit changes
nothing; the fallback render follows the fleet and the pooled render
gives a free slot's tiles no launch. The fleet's slot bookkeeping
(`serve/fleet.py`) equals JAX's op by op."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close, assert_equal, assert_states_equal, np_,
                           state_arrays, to_torch_codec, to_torch_rig, to_torch_tree)

from repro.core.camera import StereoRig, make_camera
from repro.core.pipeline import SessionConfig as JConfig
from repro.serve import fleet as jflt
from repro.serve import lod_service as jsvc
from repro_torch import kernels as tkernels
from repro_torch.core import lod_search as tls
from repro_torch.core.pipeline import SessionConfig as TConfig
from repro_torch.serve import fleet as tflt
from repro_torch.serve import lod_service as tsvc

FOCAL = 1400.0
TAU = 32.0
STAT_FIELDS = [f.name for f in dataclasses.fields(tsvc.ServiceStats)]
GAUSS_FIELDS = ("mu", "log_scale", "quat", "opacity", "sh")


@pytest.fixture(scope="module")
def ttrees(small_tree, tiny_tree):
    return {"small": to_torch_tree(small_tree), "tiny": to_torch_tree(tiny_tree)}


def _cam(rng):
    return rng.uniform([5.0, 5.0, 1.5], [55.0, 55.0, 8.0]).astype(np.float32)


def _gen_schedule(rng, steps, start_clients, max_clients):
    """The admit/evict/sync schedule of `tests/test_fleet_churn.py` (client
    ids follow the service's monotone assignment)."""
    alive = list(range(start_clients))
    next_id = start_clients
    pos = {cid: _cam(rng) for cid in alive}
    events = []
    for _ in range(steps):
        if len(alive) > 1 and rng.random() < 0.3:
            cid = alive[int(rng.integers(len(alive)))]
            alive.remove(cid)
            events.append(("evict", cid))
        if len(alive) < max_clients and rng.random() < 0.5:
            cam = _cam(rng)
            events.append(("admit", next_id, cam))
            pos[next_id] = cam
            alive.append(next_id)
            next_id += 1
        moves = {}
        for cid in alive:
            pos[cid] = (pos[cid] + rng.normal(0, 4.0, 3)).astype(np.float32)
            moves[cid] = pos[cid].copy()
        events.append(("sync", moves))
    return events


def assert_stats_equal(t_stats, j_stats, ctx=""):
    assert_states_equal(t_stats, j_stats, ctx)


def make_pair(jtree, ttree, n, mode="pooled", **kw):
    """The JAX service (pooled, XLA sweep) and the port's in `mode`, with the
    JAX codec on both."""
    jcfg = JConfig(tau=TAU, cut_budget=kw.pop("cut_budget", 8192))
    tcfg = TConfig(**dataclasses.asdict(jcfg))
    js = jsvc.LodService(jtree, jcfg, n, focal=FOCAL, mode="pooled", **kw)
    ts = tsvc.LodService(ttree, tcfg, n, focal=FOCAL, mode=mode, device=CPU, **kw)
    ts.codec = to_torch_codec(js.codec)
    return js, ts


def assert_deltas_equal(ts, js, ctx=""):
    for cid in js.active_ids:
        (tids, tdec), (jids, jdec) = ts.client_delta(cid), js.client_delta(cid)
        assert_equal(tids, jids, f"{ctx}: client {cid} ids")
        sel = np.asarray(jids) >= 0
        for f in GAUSS_FIELDS:
            assert_close(np_(getattr(tdec, f))[sel], np.asarray(getattr(jdec, f))[sel],
                         1e-6, 1e-6, f"{ctx}: client {cid} {f}")


def run_pair(js, ts, schedule, payload=True, check=None):
    """Drive both services through one schedule, holding stats, state and
    (with `payload`) the decoded Δ slices equal after every sync. Returns
    the port's per-client sync records and camera histories."""
    log, hist = {}, {}
    for k, ev in enumerate(schedule):
        if ev[0] == "admit":
            assert ts.admit(ev[2]) == js.admit(ev[2]) == ev[1]
        elif ev[0] == "evict":
            ts.evict(ev[1])
            js.evict(ev[1])
        else:
            tst, jst = ts.sync(dict(ev[1])), js.sync(dict(ev[1]))
            assert_stats_equal(tst, jst, f"event {k}")
            assert_states_equal(ts.state, js.state, f"event {k}")
            if payload and ts.dedup:
                assert_deltas_equal(ts, js, f"event {k}")
            for cid in ts.active_ids:
                slot = ts._slot_of(cid)
                log.setdefault(cid, []).append(
                    {"cut": np_(ts.state.cut_gids[slot]).copy(),
                     **{f: np_(getattr(tst, f))[slot].item() for f in STAT_FIELDS}})
                hist.setdefault(cid, []).append(ev[1][cid])
        assert ts.capacity == js.capacity == ts.state.capacity
        assert ts.active_ids == js.active_ids
        np.testing.assert_array_equal(ts._active, js._active)
        # the host mirror agrees with the device's fleet bookkeeping
        active, ids, next_id = tflt.fleet_mirror(ts.state.fleet)
        np.testing.assert_array_equal(active, ts._active)
        np.testing.assert_array_equal(ids[active], ts._client_ids[ts._active])
        assert next_id == ts._next_id
        if check is not None:
            check(ts)
    return log, hist


def replay_alone(ttree, hist, dedup, codec):
    """A fresh one-client port service replaying one survivor's cameras."""
    ref = tsvc.LodService(ttree, TConfig(tau=TAU, cut_budget=8192), 1, focal=FOCAL,
                          dedup=dedup, device=CPU)
    ref.codec = codec
    out = []
    for cam in hist:
        st = ref.sync(np.asarray([cam], np.float32))
        out.append({"cut": np_(ref.state.cut_gids[0]).copy(),
                    **{f: np_(getattr(st, f))[0].item() for f in STAT_FIELDS}})
    return out


# -- churn conformance ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["pooled", "vmapped"])
def test_churn_conformance_matches_jax(small_tree, ttrees, mode):
    """The seeded schedule of the JAX churn test (5 concurrent clients: one
    growth 4 -> 8; three evicts, slots recycled) on the port in each mode
    against the JAX service: every stats column, every state leaf and each
    client's decoded Δ slice equal after every sync. Each survivor also
    replays bitwise on a fresh one-client port service (all but the shared
    stream's byte split, which depends on who shares a row)."""
    schedule = _gen_schedule(np.random.default_rng(72), steps=7, start_clients=2,
                             max_clients=5)
    js, ts = make_pair(small_tree, ttrees["small"], 2, mode=mode, capacity=4)
    log, hist = run_pair(js, ts, schedule)
    assert ts.capacity == 8 and len(ts.active_ids) >= 2
    for cid in ts.active_ids:
        want = replay_alone(ttrees["small"], hist[cid], True, ts.codec)
        assert len(want) == len(log[cid])
        for k, (got, ref) in enumerate(zip(log[cid], want)):
            for key in ref:
                if key in ("sync_bytes", "dedup_bytes_saved", "unique_delta"):
                    continue
                np.testing.assert_array_equal(got[key], ref[key],
                                              err_msg=f"cid {cid} sync {k}: {key}")


def test_churn_unicast_byte_accounting(small_tree, ttrees):
    """With the unicast wire a client's bytes do not depend on the rest of
    the fleet: the port equals JAX, and each survivor's bytes replay bit for
    bit on a fresh one-client service."""
    schedule = _gen_schedule(np.random.default_rng(7), steps=5, start_clients=2,
                             max_clients=4)
    js, ts = make_pair(small_tree, ttrees["small"], 2, capacity=4, dedup=False)
    log, hist = run_pair(js, ts, schedule, payload=False)
    assert ts.active_ids
    for cid in ts.active_ids:
        want = replay_alone(ttrees["small"], hist[cid], False, ts.codec)
        for k, (got, ref) in enumerate(zip(log[cid], want)):
            for key in ref:
                np.testing.assert_array_equal(got[key], ref[key],
                                              err_msg=f"cid {cid} sync {k}: {key}")


# -- inactive slots are free; recycled slots are fresh -------------------------


def _assert_slot_fresh(state, fresh, slot, ctx=""):
    sa, fa = state_arrays(state), state_arrays(fresh)
    for k in sa:
        if k.startswith("fleet/"):
            continue
        np.testing.assert_array_equal(sa[k][slot], fa[k][slot], err_msg=f"{ctx}: {k}")


def test_inactive_slots_are_free(small_tree, ttrees):
    """Free slots add nothing (zero stats rows, header included; no union
    rows) and stay bitwise at the reset value, before and after an evict;
    the stats equal JAX's."""
    js, ts = make_pair(small_tree, ttrees["small"], 3, capacity=8)
    fresh = tsvc.service_init(ts.tree, ts.cfg, 0, capacity=8)
    rng = np.random.default_rng(3)
    cams = np.stack([_cam(rng) for _ in range(3)])
    for f in range(4):
        c = cams + rng.normal(0, 3.0, cams.shape).astype(np.float32)
        tst, jst = ts.sync(c), js.sync(c)
        assert_stats_equal(tst, jst, f"sync {f}")
        inactive = ~ts._active
        assert inactive.sum() == 5
        for name in STAT_FIELDS:
            assert not np_(getattr(tst, name))[inactive].any(), (f, name)
        assert not np_(ts.last_delta.ref_mask)[inactive].any()
        np.testing.assert_array_equal(np_(ts.state.fleet.active), ts._active)
        for slot in np.flatnonzero(inactive):
            _assert_slot_fresh(ts.state, fresh, int(slot), f"sync {f} slot {slot}")
    victim = ts.active_ids[1]
    v_slot = ts._slot_of(victim)
    ts.evict(victim)
    js.evict(victim)
    _assert_slot_fresh(ts.state, fresh, v_slot, "evicted")
    tst, jst = ts.sync(), js.sync()
    assert_stats_equal(tst, jst, "after evict")
    assert float(tst.sync_bytes[v_slot]) == 0.0
    _assert_slot_fresh(ts.state, fresh, v_slot, "evicted + sync")
    assert_states_equal(ts.state, js.state, "after evict")


def test_recycled_slot_is_indistinguishable_from_fresh(small_tree, ttrees):
    """A new tenant of a heavily used slot syncs exactly like the first sync
    of a fresh one-client service; the old tenant's payload slice is not
    readable through it."""
    js, ts = make_pair(small_tree, ttrees["small"], 2, capacity=2)
    rng = np.random.default_rng(11)
    cams = np.stack([_cam(rng), _cam(rng)])
    for _ in range(3):
        ts.sync(cams)
        js.sync(cams)
        cams = cams + rng.normal(0, 5.0, cams.shape).astype(np.float32)
    ts.evict(0)
    js.evict(0)
    cam_new = _cam(rng)
    cid = ts.admit(cam_new)
    assert cid == js.admit(cam_new)
    assert ts._slot_of(cid) == 0
    assert int(ts.state.fleet.generation[0]) == 2
    assert ts.state.fleet.generation.dtype == torch.int32
    with pytest.raises(ValueError, match="predates"):
        ts.client_delta(cid)
    tst, jst = ts.sync({cid: cam_new}), js.sync({cid: cam_new})
    assert_stats_equal(tst, jst, "recycled")
    assert_states_equal(ts.state, js.state, "recycled")
    ref = replay_alone(ttrees["small"], [cam_new], True, ts.codec)[0]
    got = {"cut": np_(ts.state.cut_gids[0]),
           **{f: np_(getattr(tst, f))[0].item() for f in STAT_FIELDS}}
    for key in ("cut", "cut_size", "delta_size", "client_resident", "resweeps",
                "nodes_touched"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    assert got["sync_bytes"] > 0


def test_capacity_growth_follows_pow2_buckets(small_tree, ttrees):
    """An admit into a full slot array grows it to the next pow2 bucket; the
    live clients' cuts are untouched; unknown ids raise."""
    js, ts = make_pair(small_tree, ttrees["small"], 2, capacity=2, cut_budget=4096)
    cams = {0: [30.0, 30.0, 2.0], 1: [40.0, 40.0, 2.0]}
    ts.sync(cams)
    js.sync(cams)
    pre = {cid: np_(ts.client_cut(cid)).copy() for cid in (0, 1)}
    ts.admit([35.0, 35.0, 2.0])
    js.admit([35.0, 35.0, 2.0])
    assert ts.capacity == tls.pow2_bucket(3, tflt.MAX_CAPACITY) == 4
    for _ in range(2):
        ts.admit([20.0, 20.0, 2.0])
        js.admit([20.0, 20.0, 2.0])
    assert ts.capacity == 8 and ts.n_clients == 5
    assert ts.delta_budget == js.delta_budget
    for cid in (0, 1):
        assert_equal(ts.client_cut(cid), pre[cid])
    assert_states_equal(ts.state, js.state, "grown")
    with pytest.raises(KeyError):
        ts.evict(99)
    with pytest.raises(ValueError):
        tsvc.LodService(ts.tree, ts.cfg, 4, focal=FOCAL, capacity=2, device=CPU)


# -- the fleet's slot bookkeeping ---------------------------------------------------


def _fleet_arrays(f):
    return [np_(f.active), np_(f.generation), np_(f.client_ids), int(np_(f.next_id))]


def test_fleet_slot_bookkeeping_matches_jax():
    """admit, evict, grow, shrink, the host mirror and the slot surgery of
    `serve/fleet.py` against JAX's on one script: equal values and dtypes,
    ids monotone across the shrink."""
    jf, tf = jflt.fleet_init(4, 2), tflt.fleet_init(4, 2, device=CPU)
    script = [("admit", 2, 5), ("evict", 0), ("admit", 0, 6), ("grow", 8),
              ("admit", 5, 9), ("evict", 2), ("shrink", [0, 1, 5, 2])]
    for op in script:
        if op[0] == "admit":
            jf, tf = jflt.fleet_admit_slot(jf, op[1], op[2]), tflt.fleet_admit_slot(tf, *op[1:])
        elif op[0] == "evict":
            jf, tf = jflt.fleet_evict_slot(jf, op[1]), tflt.fleet_evict_slot(tf, op[1])
        elif op[0] == "grow":
            jf, tf = jflt.fleet_grow(jf, op[1]), tflt.fleet_grow(tf, op[1])
        else:
            jf, tf = jflt.fleet_shrink(jf, op[1]), tflt.fleet_shrink(tf, op[1])
        for f in ("active", "generation", "client_ids", "next_id"):
            assert getattr(tf, f).dtype == getattr(torch, str(np.asarray(getattr(jf, f)).dtype))
        for a, b in zip(_fleet_arrays(tf), _fleet_arrays(jf)):
            np.testing.assert_array_equal(a, b, err_msg=str(op))
        for a, b in zip(tflt.fleet_mirror(tf), jflt.fleet_mirror(jf)):
            np.testing.assert_array_equal(a, b, err_msg=str(op))
            assert np.asarray(a).dtype == np.asarray(b).dtype
    assert tf.capacity == 4 and int(tf.next_id) == 10
    np.testing.assert_array_equal(tflt.slots_mask(8, [1, 6]), jflt.slots_mask(8, [1, 6]))
    with pytest.raises(ValueError):
        tflt.slots_mask(4, [4])
    rng = np.random.default_rng(2)
    batched = (rng.normal(size=(4, 3)).astype(np.float32),
               rng.integers(0, 9, (4,)).astype(np.int32))
    fresh = (np.zeros((3,), np.float32), np.asarray(-1, np.int32))
    tb, tfr = tuple(map(torch.from_numpy, batched)), tuple(map(torch.from_numpy, fresh))
    jb, jfr = tuple(map(jnp.asarray, batched)), tuple(map(jnp.asarray, fresh))
    for got, want in (
            (tflt.reset_slot(tb, tfr, 2), jflt.reset_slot(jb, jfr, 2)),
            (tflt.pad_slots(tb, tfr, 8), jflt.pad_slots(jb, jfr, 8)),
            (tflt.take_slots(tb, [3, 0]), jflt.take_slots(jb, [3, 0]))):
        for g, w in zip(got, want, strict=True):
            assert_equal(g, w)
    assert_equal(tb[0], batched[0], "surgery leaves its input as it was")


# -- shrink ---------------------------------------------------------------------


def test_shrink_survivors_replay_bitwise(small_tree, ttrees):
    """Grow to 8 slots, evict down to 3 clients in scattered slots, shrink to
    4 and sync on: the port equals JAX before and after the shrink (state,
    stats, decoded slices through the remapped payload), the survivors' cuts
    are unchanged by the shrink itself, and their later syncs equal those
    of a service that never shrank."""
    js, ts = make_pair(small_tree, ttrees["small"], 4, capacity=4)
    _j2, never = make_pair(small_tree, ttrees["small"], 4, capacity=4)
    never.codec = ts.codec
    rng = np.random.default_rng(5)
    pos = {c: _cam(rng) for c in range(6)}
    for s in (ts, js, never):
        for c in (4, 5):
            assert s.admit(pos[c]) == c
    moves = {c: pos[c] for c in range(6)}
    for s in (ts, js, never):
        s.sync(moves)
    for s in (ts, js, never):
        for c in (0, 2, 5):
            s.evict(c)
    moves = {c: pos[c] + 1.5 for c in (1, 3, 4)}
    for s in (ts, js, never):
        s.sync(moves)
    assert ts.capacity == 8
    cuts = {c: np_(ts.client_cut(c)).copy() for c in (1, 3, 4)}
    assert ts.maybe_shrink() == js.maybe_shrink() == 4
    assert ts.maybe_shrink() is None
    assert ts.active_ids == js.active_ids == [1, 3, 4]
    assert_states_equal(ts.state, js.state, "shrunk")
    for c in (1, 3, 4):
        assert_equal(ts.client_cut(c), cuts[c], f"cut of {c} across the shrink")
    assert_deltas_equal(ts, js, "shrunk payload")
    for t in range(2):
        moves = {c: pos[c] + 3.0 + t for c in (1, 3, 4)}
        tst, jst, nst = ts.sync(moves), js.sync(moves), never.sync(moves)
        assert_stats_equal(tst, jst, f"after shrink {t}")
        assert_states_equal(ts.state, js.state, f"after shrink {t}")
        for c in (1, 3, 4):
            a, b = ts._slot_of(c), never._slot_of(c)
            for f in STAT_FIELDS:
                assert_equal(getattr(tst, f)[a], getattr(nst, f)[b], f"{c} {f}")
            assert_equal(ts.client_cut(c), never.client_cut(c))


# -- the recompile contract's torch form ---------------------------------------------


def test_launch_sizes_stay_on_the_pow2_buckets(ttrees):
    """The JAX service retraces once a capacity bucket; eager PyTorch traces
    nothing, and a kernel takes its sizes at launch. What the pow2 buckets
    bound here is the set of launch sizes: over a churn script that grows
    4 -> 8 and shrinks back, every pooled K6 launch (stale pairs) and every
    K5 launch (Δ-union width) has a power-of-two size or the cap its bucket
    is clamped to (all pairs of the capacity; the Δ-stream budget)."""
    from unittest import mock

    from repro_torch.core import compression as tcomp
    ts = tsvc.LodService(ttrees["tiny"], TConfig(tau=24.0, cut_budget=2048), 2,
                         focal=FOCAL, capacity=4, device=CPU)
    sizes, caps = {"k6": set(), "k5": set()}, {"k6": set(), "k5": set()}

    def recorder(key, fn):
        def run(*a, **kw):
            sizes[key].add(int(a[0].shape[0]))
            caps["k6"].add(ts.capacity * ts.tree.meta.Ns)
            caps["k5"].add(ts.delta_budget)
            return fn(*a, **kw)
        return run

    rng = np.random.default_rng(4)
    with mock.patch.object(tsvc, "lod_pair_sweep", recorder("k6", tsvc.lod_pair_sweep)), \
            mock.patch.object(tcomp, "vq_assign", recorder("k5", tcomp.vq_assign)):
        for step in range(12):
            if step in (1, 2, 3):
                ts.admit(_cam(rng) * 0.5)
            if step in (6, 7, 8) and ts.n_clients > 1:
                ts.evict(ts.active_ids[0])
            if step == 9:
                assert ts.maybe_shrink() == 2
            ts.sync({c: _cam(rng) * 0.5 for c in ts.active_ids})
    assert ts.capacity == 2 and len(caps["k6"]) == 3
    for key in sizes:
        off = [n for n in sizes[key] if n & (n - 1) and n not in caps[key]]
        assert sizes[key] and not off, (key, sorted(sizes[key]), caps[key])


# -- admission control ------------------------------------------------------------


def test_admission_denied_leaves_service_untouched(small_tree, ttrees):
    """`max_clients` and `max_state_bytes` deny an admit before anything
    changes; the per-slot state bytes (every slot-axis leaf, the fleet's
    included) equal JAX's, so the byte budget denies at the same point."""
    js, ts = make_pair(small_tree, ttrees["small"], 2, capacity=2, max_clients=3)
    assert ts._slot_state_bytes() == js._slot_state_bytes()
    ts.admit([30.0, 30.0, 2.0])
    state, cap = ts.state, ts.capacity
    with pytest.raises(tsvc.AdmissionDenied, match="max_clients"):
        ts.admit([31.0, 30.0, 2.0])
    assert ts.admit([31.0, 30.0, 2.0], required=False) is None
    assert ts.state is state and ts.capacity == cap and ts.n_clients == 3

    per_slot = js._slot_state_bytes()
    budget = per_slot * 3          # the 2 slots fit, a grown 4 do not
    js2, ts2 = make_pair(small_tree, ttrees["small"], 2, capacity=2,
                         max_state_bytes=budget)
    msg_t, msg_j = ts2._admission_denial(), js2._admission_denial()
    assert msg_t == msg_j and "max_state_bytes" in msg_t
    state = ts2.state
    with pytest.raises(tsvc.AdmissionDenied):
        ts2.admit([30.0, 30.0, 2.0])
    assert ts2.state is state and ts2.capacity == 2 and ts2._next_id == 2
    ts2.evict(1)
    assert ts2.admit([30.0, 30.0, 2.0]) == 2     # a free slot costs nothing


# -- the fallback render ------------------------------------------------------------


def _rig_at(pos, width=64, height=48):
    cam = make_camera(list(np.asarray(pos, np.float32)),
                      list(np.asarray(pos, np.float32) + [10, 10, -0.2]),
                      focal_px=200.0, width=width, height=height, near=0.25)
    return StereoRig(left=cam, baseline=0.06)


def test_render_fallback_fleet_cache_key(small_tree, ttrees):
    """The render follows the fleet (what the JAX service's render cache key
    guards; the port builds the rig stack each call): after an evict the old
    rig list is refused, the evicted slot renders black and the others are
    unchanged; a re-admitted client that has not synced renders black."""
    js, ts = make_pair(small_tree, ttrees["small"], 3, capacity=4, cut_budget=4096)
    cams = np.asarray([[30, 30, 2], [40, 32, 3], [26, 44, 2]], np.float32)
    ts.sync(cams)
    rigs = [to_torch_rig(_rig_at(c)) for c in cams]
    il0, ir0, _ = ts.render_fallback(rigs, list_len=128, max_pairs=1 << 15)
    assert il0.shape[0] == 4
    ts.evict(1)
    with pytest.raises(ValueError):
        ts.render_fallback(rigs, list_len=128, max_pairs=1 << 15)
    il1, ir1, _ = ts.render_fallback([rigs[0], rigs[2]], list_len=128, max_pairs=1 << 15)
    assert not il1[1].any() and not ir1[1].any()
    for slot in (0, 2):
        assert torch.equal(il1[slot], il0[slot]) and torch.equal(ir1[slot], ir0[slot])
    cid = ts.admit(cams[1])
    il2, _, _ = ts.render_fallback([rigs[0], to_torch_rig(_rig_at(cams[1])), rigs[2]],
                                   list_len=128, max_pairs=1 << 15)
    assert not il2[ts._slot_of(cid)].any()


def test_pooled_render_masks_inactive_tiles(small_tree, ttrees):
    """The pooled render gives free slots no tiles (black frames, zero
    stats), equals the per-client render on the live ones, and matches
    JAX's per-client render within the fleet render test's tolerance."""
    js, ts = make_pair(small_tree, ttrees["small"], 2, capacity=4, cut_budget=2048)
    cams = np.asarray([[30, 30, 2], [40, 32, 3]], np.float32)
    ts.sync(cams)
    js.sync(cams)
    jrigs = [_rig_at(c) for c in cams]
    rigs = [to_torch_rig(r) for r in jrigs]
    tkernels.reset_launch_counts()
    pl, pr, ps = ts.render_fallback(rigs, list_len=128, max_pairs=1 << 15, path="pooled")
    vl, vr, vs = ts.render_fallback(rigs, list_len=128, max_pairs=1 << 15, path="vmap")
    assert sum(tkernels.launch_counts().values()) == 0   # CPU: plain versions
    assert not pl[2:].any() and not pr[2:].any()
    assert torch.equal(pl, vl) and torch.equal(pr, vr)
    # the pooled launch keeps the Pallas contract (no flag past a stop): it
    # skips at least as many right entries; every other stat is equal
    for f in dataclasses.fields(ps):
        a, b = getattr(ps, f.name), getattr(vs, f.name)
        assert bool((a >= b).all()) if f.name == "right_alpha_skipped" else torch.equal(a, b), \
            f.name
        assert not a[2:].any(), f.name
    jl, jr, _ = js.render_fallback(jrigs, list_len=128, max_pairs=1 << 15, path="vmap")
    assert_close(pl, jl, 1e-4, 1e-5)
    assert_close(pr, jr, 1e-4, 1e-5)
