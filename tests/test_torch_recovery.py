"""The port's fleet recovery (`repro_torch.serve.recovery`,
`LodService.snapshot/restore`), mirroring the meshless tests of
`tests/test_fleet_recovery.py` on the schedules of
`tests/test_torch_fleet_churn.py`:

  * kill and restore: a service snapshotted mid-churn, dropped and restored
    finishes its schedule bit for bit with one that never stopped (every
    stats column, every state leaf, every host mirror, the decoded Δ
    slices), on the pooled and the vmapped scheduler; debt and the rate
    controller's feedback survive; a restored payload refuses stale reads;
  * journal recovery from crashes at seeded points, NACKs and bandwidth
    re-tiers replayed, denied admits never journaled, snapshot-every-K and
    GC;
  * the ten injected faults: each ends in a restore from an earlier point
    or a typed `RecoveryError`;
  * the journal's format: round trip, repair, cameras bit for bit.

And the cross-package legs: (a) a run journaled by JAX's `RecoveryManager`
is recovered by the port and continues equal to the uninterrupted JAX
service; (b) the other way round, through JAX's unchanged `recover`; (c)
the two packages' snapshots of one state are the same files byte for byte;
(d) a JAX scheduler's `state_dict` carried in the extras loads into the
port's scheduler and the next tick equals JAX's; and a snapshot JAX took
under a 1×1 mesh restores into the port. Ids, counts and flags are held
exactly, `sync_bytes` bit for bit. The multi-device mesh tests of the
reference wait for the port's mesh.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import CPU, assert_states_equal, np_, to_torch_codec, to_torch_tree
from test_torch_fleet_churn import _cam, _gen_schedule

from repro.core.pipeline import SessionConfig as JConfig
from repro.serve import lod_service as jsvc
from repro.serve import recovery as jrec
from repro.serve import scheduler as jsch
from repro_torch import pytree
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core.pipeline import SessionConfig as TConfig
from repro_torch.serve import lod_service as tsvc
from repro_torch.serve import recovery as rec
from repro_torch.serve import scheduler as tsch

FOCAL = 1400.0
TAU = 32.0
CFG = dict(tau=24.0, cut_budget=2048)
STAT_FIELDS = [f.name for f in dataclasses.fields(tsvc.ServiceStats)]
GAUSS_FIELDS = ("mu", "log_scale", "quat", "opacity", "sh")
HOST_MIRRORS = ("_active", "_client_ids", "_slot_cams", "_delta_ids", "_bw_target",
                "_allowance", "_tau_scale", "_stats_fresh")


@pytest.fixture(scope="module")
def ttiny(tiny_tree):
    return to_torch_tree(tiny_tree)


def _port(ttree, n=1, cfg=None, **kw):
    return tsvc.LodService(ttree, TConfig(**(cfg or CFG)), n, focal=FOCAL, device=CPU, **kw)


def _record(service, stats, cid, payload):
    """One client's view of one sync: its cut, its row of every stats
    column and (`payload` "rows" or "ids") its slice of the Δ payload."""
    slot = service._slot_of(cid)
    out = {"cut": np_(service.state.cut_gids[slot]).copy(),
           **{f: np_(getattr(stats, f))[slot].copy() for f in STAT_FIELDS}}
    if payload and service.dedup:
        ids, dec = service.client_delta(cid)
        ids = np_(ids)
        sel = ids >= 0
        out["delta_ids"] = ids[sel].copy()
        if payload == "rows":
            for f in GAUSS_FIELDS:
                out[f"delta_{f}"] = np_(getattr(dec, f))[sel].copy()
    return out


def _play(ops, service, events, log=None, payload="rows"):
    """Drive `ops` (a service or a `RecoveryManager` over `service`) through
    schedule `events`, recording every live client's view of each sync."""
    log = {} if log is None else log
    for ev in events:
        if ev[0] == "admit":
            assert ops.admit(ev[2]) == ev[1]
            log.setdefault(ev[1], [])
        elif ev[0] == "evict":
            ops.evict(ev[1])
        else:
            stats = ops.sync(dict(ev[1]))
            for cid in service.active_ids:
                log.setdefault(cid, []).append(_record(service, stats, cid, payload))
    return log


def _assert_logs_equal(a, b, ctx):
    assert a.keys() == b.keys(), (ctx, sorted(a), sorted(b))
    for cid in a:
        assert len(a[cid]) == len(b[cid]), (ctx, cid)
        for k, (x, y) in enumerate(zip(a[cid], b[cid])):
            assert x.keys() == y.keys(), ctx
            for key in x:
                assert x[key].dtype == y[key].dtype, (ctx, cid, k, key)
                np.testing.assert_array_equal(x[key], y[key],
                                              err_msg=f"{ctx}/cid{cid}/sync{k}/{key}")


def _assert_services_bitwise(got, want, ctx="", mirror_dtypes=True):
    """Every `ServiceState` leaf, every host mirror, the controller's last
    measured bytes and the id counter agree bit for bit (either package on
    either side). JAX's own restore brings its int64 host mirrors back as
    int32 (no x64): `mirror_dtypes=False` compares their values only."""
    assert got.capacity == want.capacity, ctx
    assert_states_equal(got.state, want.state, ctx)
    for f in HOST_MIRRORS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype or not mirror_dtypes, f"{ctx}:{f}"
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}:{f}")
    assert got._next_id == want._next_id, ctx
    assert (got.taus is None) == (want.taus is None), ctx
    if got.taus is not None:
        np.testing.assert_array_equal(got.taus, want.taus, err_msg=ctx)
    assert (got._last_stats is None) == (want._last_stats is None), ctx
    if got._last_stats is not None:
        a, b = np_(got._last_stats.sync_bytes), np_(want._last_stats.sync_bytes)
        assert a.dtype == b.dtype == np.float32, ctx
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}:last sync_bytes")


def _assert_on(service, device):
    for key, leaf in pytree.flatten_with_paths(service.state):
        assert leaf.device.type == device, key
    assert service.tree.device.type == device
    if service._last_stats is not None:
        assert service._last_stats.sync_bytes.device.type == device


# ---------------------------------------------------------------------------
# (a) snapshot -> kill -> restore replays bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["pooled", "vmapped"])
def test_kill_restore_bitwise_across_paths(ttiny, tmp_path, mode):
    schedule = _gen_schedule(np.random.default_rng(31), steps=6, start_clients=2,
                             max_clients=4)
    cut = len(schedule) // 2

    def mk():
        return _port(ttiny, 2, capacity=4, mode=mode)

    oracle = mk()
    _play(oracle, oracle, schedule[:cut])
    victim = mk()
    _play(victim, victim, schedule[:cut])
    victim.snapshot(str(tmp_path))
    del victim  # the kill: nothing in memory survives

    restored = tsvc.LodService.restore(ttiny, str(tmp_path), device=CPU)
    assert restored.mode == mode
    _assert_on(restored, "cpu")
    _assert_services_bitwise(restored, oracle, f"{mode}:post-restore")
    log_r = _play(restored, restored, schedule[cut:])
    log_o = _play(oracle, oracle, schedule[cut:])
    _assert_logs_equal(log_r, log_o, mode)
    _assert_services_bitwise(restored, oracle, f"{mode}:final")


def test_restore_preserves_debt_and_rate_controller(small_tree, tmp_path):
    """A tight Δ budget leaves carried debt, and a bandwidth-controlled
    client's loop feeds on the previous sync's float32 bytes: snapshot mid
    debt, restore, and drain; every later sync, byte split included,
    equals the uninterrupted run's."""
    tsmall = to_torch_tree(small_tree)
    cams = np.asarray([[40.0, 40.0, 2.0], [46.0, 41.0, 2.5], [38.0, 47.0, 3.0]], np.float32)

    def mk():
        return _port(tsmall, 3, cfg=dict(tau=TAU, cut_budget=8192), dedup=True,
                     delta_budget=128, page_size=64)

    oracle, victim = mk(), mk()
    for s in (oracle, victim):
        s.set_bandwidth(0, 6000.0)
        s.sync(cams)
    assert bool(victim.state.pending.any())
    victim.snapshot(str(tmp_path))
    del victim

    restored = tsvc.LodService.restore(tsmall, str(tmp_path), device=CPU)
    assert bool(restored.state.pending.any())
    assert restored.client_bandwidth(0) == oracle.client_bandwidth(0)
    assert restored.client_bandwidth(0)[0] == 6000.0
    _assert_services_bitwise(restored, oracle, "restored")
    for k in range(32):
        st_r, st_o = restored.sync(cams), oracle.sync(cams)
        for cid in (0, 1, 2):
            _assert_logs_equal({cid: [_record(restored, st_r, cid, "rows")]},
                               {cid: [_record(oracle, st_o, cid, "rows")]}, f"drain {k}")
        assert restored.client_bandwidth(0) == oracle.client_bandwidth(0)
        if not bool(oracle.state.pending.any()):
            break
    assert not bool(restored.state.pending.any())
    _assert_services_bitwise(restored, oracle, "drained")


def test_restored_payload_tenancy_refuses_stale_reads(ttiny, tmp_path):
    s = _port(ttiny, 2, capacity=4)
    cams = np.stack([_cam(np.random.default_rng(3)) for _ in range(2)])
    s.sync(cams)
    s.client_delta(0)
    s.snapshot(str(tmp_path))
    r = tsvc.LodService.restore(ttiny, str(tmp_path), device=CPU)
    with pytest.raises(ValueError, match="no sync performed yet"):
        r.client_delta(0)
    with pytest.raises(ValueError, match="no sync performed yet"):
        r.resolve_nack(0, [0])
    r.sync(cams)
    ids, _ = r.client_delta(0)
    assert ids.shape[0] > 0


# ---------------------------------------------------------------------------
# (b) journaled runs recover from seeded crash points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,crash_at", [(3, 1), (11, 4), (19, 7)])
def test_journal_recover_randomized_crash(ttiny, tmp_path, seed, crash_at):
    schedule = _gen_schedule(np.random.default_rng(seed), steps=6, start_clients=1,
                             max_clients=4)
    crash_at = min(crash_at, len(schedule) - 1)

    def mk():
        return _port(ttiny, 1, capacity=4, mode="pooled")

    oracle = mk()
    _play(oracle, oracle, schedule[:crash_at])
    victim = mk()
    mgr = rec.RecoveryManager(victim, str(tmp_path), every=2, keep=2)
    _play(mgr, victim, schedule[:crash_at])
    del victim, mgr  # crash

    mgr2, replayed = rec.recover(ttiny, str(tmp_path), device=CPU)
    assert 0 <= replayed <= len(schedule)
    _assert_services_bitwise(mgr2.service, oracle, "post-recover")
    log_r = _play(mgr2, mgr2.service, schedule[crash_at:])
    log_o = _play(oracle, oracle, schedule[crash_at:])
    _assert_logs_equal(log_r, log_o, "post-recover")
    _assert_services_bitwise(mgr2.service, oracle, "final")


def test_journal_replays_nack_and_bandwidth(ttiny, tmp_path):
    """NACKs journal their resolved gids (the payload dies with the
    process) and bandwidth re-tiers replay: a crash right after both
    recovers the exact debt and controller seed."""
    cams = np.asarray([[12.0, 9.0, 2.0], [20.0, 18.0, 3.0]], np.float32)

    def mk():
        return _port(ttiny, 2, capacity=4, mode="pooled", dedup=True)

    oracle, victim = mk(), mk()
    mgr = rec.RecoveryManager(victim, str(tmp_path), every=100, keep=2)
    oracle.sync(cams)
    mgr.sync(cams)
    assert int(victim.last_delta.pages) >= 1
    n_o, n_v = oracle.nack(0, [0]), mgr.nack(0, [0])
    assert n_o == n_v > 0
    oracle.set_bandwidth(1, 4000.0)
    mgr.set_bandwidth(1, 4000.0)
    del victim, mgr

    mgr2, replayed = rec.recover(ttiny, str(tmp_path), device=CPU)
    assert replayed == 3
    _assert_services_bitwise(mgr2.service, oracle, "nack-replay")
    st_r, st_o = mgr2.sync(cams), oracle.sync(cams)
    for cid in (0, 1):
        _assert_logs_equal({cid: [_record(mgr2.service, st_r, cid, "rows")]},
                           {cid: [_record(oracle, st_o, cid, "rows")]}, "post-nack")


def test_manager_denied_admit_never_journaled(ttiny, tmp_path):
    s = _port(ttiny, 1, capacity=4, max_clients=1)
    mgr = rec.RecoveryManager(s, str(tmp_path), every=8)
    assert mgr.admit(required=False) is None
    with pytest.raises(tsvc.AdmissionDenied):
        mgr.admit(cam=_cam(np.random.default_rng(0)))
    assert rec.SyncJournal.read(os.path.join(str(tmp_path), rec.JOURNAL_NAME)) == []
    mgr2, replayed = rec.recover(ttiny, str(tmp_path), device=CPU)
    assert replayed == 0
    assert mgr2.service.active_ids == [0]


def test_snapshot_every_k_bounds_replay_and_gc_bounds_disk(ttiny, tmp_path):
    s = _port(ttiny, 1, capacity=4)
    mgr = rec.RecoveryManager(s, str(tmp_path), every=2, keep=2)
    cam = _cam(np.random.default_rng(1))
    for _ in range(7):
        mgr.sync({0: cam})
    assert len(ckpt.valid_steps(mgr.snapshot_dir)) == 2
    del s, mgr
    _mgr2, replayed = rec.recover(ttiny, str(tmp_path), every=2, keep=2, device=CPU)
    assert replayed <= 2


# ---------------------------------------------------------------------------
# (c) fault injection: a restore from an earlier point, or a typed error
# ---------------------------------------------------------------------------


def _journaled_run(ttree, directory, steps=5):
    """A journaled one-client run with >= 2 surviving snapshots. Returns the
    oracle that ran the same schedule uninterrupted."""
    cam = _cam(np.random.default_rng(5))
    oracle, s = _port(ttree, 1, capacity=4), _port(ttree, 1, capacity=4)
    mgr = rec.RecoveryManager(s, directory, every=2, keep=3)
    for k in range(steps):
        pos = (cam + k).astype(np.float32)
        oracle.sync({0: pos})
        mgr.sync({0: pos})
    assert len(ckpt.valid_steps(mgr.snapshot_dir)) >= 2
    return oracle


def _newest_step_dir(directory):
    snap = os.path.join(directory, rec.SNAPSHOT_DIRNAME)
    return os.path.join(snap, f"step_{ckpt.valid_steps(snap)[0]:08d}")


def _truncate_a_leaf(step_dir):
    leaf = sorted(n for n in os.listdir(step_dir) if n.endswith(".npy"))[0]
    path = os.path.join(step_dir, leaf)
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[: max(1, len(raw) // 2)])


def _fault_tmp_leftover(ttiny, d):
    oracle = _journaled_run(ttiny, d)
    torn = os.path.join(d, rec.SNAPSHOT_DIRNAME, "step_00000099.tmp")
    os.makedirs(torn)
    with open(os.path.join(torn, "leaf_00000.npy"), "wb") as f:
        f.write(b"\x93NUMPY garbage")
    mgr, _ = rec.recover(ttiny, d, device=CPU)
    assert not os.path.exists(torn)
    _assert_services_bitwise(mgr.service, oracle, "tmp-leftover")


def _fault_truncated_leaf(ttiny, d):
    oracle = _journaled_run(ttiny, d)
    _truncate_a_leaf(_newest_step_dir(d))
    mgr, replayed = rec.recover(ttiny, d, device=CPU)
    assert replayed >= 1  # the longer tail was replayed
    _assert_services_bitwise(mgr.service, oracle, "truncated-leaf")


def _fault_corrupt_manifest(ttiny, d):
    oracle = _journaled_run(ttiny, d)
    with open(os.path.join(_newest_step_dir(d), "manifest.json"), "w") as f:
        f.write("{not json")
    mgr, _ = rec.recover(ttiny, d, device=CPU)
    _assert_services_bitwise(mgr.service, oracle, "corrupt-manifest")


def _fault_every_snapshot_corrupt(ttiny, d):
    _journaled_run(ttiny, d)
    snap = os.path.join(d, rec.SNAPSHOT_DIRNAME)
    for step in ckpt.valid_steps(snap):
        with open(os.path.join(snap, f"step_{step:08d}", "manifest.json"), "w") as f:
            f.write("{not json")
    with pytest.raises(rec.RecoveryError, match="cannot recover"):
        rec.recover(ttiny, d, device=CPU)


def _fault_torn_journal_tail(ttiny, d):
    oracle = _journaled_run(ttiny, d)
    jpath = os.path.join(d, rec.JOURNAL_NAME)
    n_before = len(rec.SyncJournal.read(jpath, repair=False))
    with open(jpath, "ab") as f:
        f.write(b'{"kind": "sync", "cams"')
    mgr, _ = rec.recover(ttiny, d, device=CPU)
    assert len(rec.SyncJournal.read(jpath, repair=False)) == n_before
    _assert_services_bitwise(mgr.service, oracle, "torn-journal")


def _rewrite_journal(d, edit):
    jpath = os.path.join(d, rec.JOURNAL_NAME)
    with open(jpath, encoding="utf-8") as f:
        lines = f.read().splitlines()
    assert len(lines) >= 3
    edit(lines)
    with open(jpath, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")


def _fault_journal_midfile_corruption(ttiny, d):
    _journaled_run(ttiny, d)

    def smash(lines):
        lines[1] = lines[1][:-8] + "X" * 8  # the CRC field
    _rewrite_journal(d, smash)
    with pytest.raises(rec.RecoveryError, match="hole, not a torn tail"):
        rec.recover(ttiny, d, device=CPU)


def _fault_journal_seq_hole(ttiny, d):
    _journaled_run(ttiny, d)
    _rewrite_journal(d, lambda lines: lines.pop(1))
    with pytest.raises(rec.RecoveryError, match="records are missing"):
        rec.recover(ttiny, d, device=CPU)


def _fault_wrong_tree(ttiny, d, small_tree):
    s = _port(ttiny, 1, capacity=4)
    s.sync({0: _cam(np.random.default_rng(2))})
    s.snapshot(d)
    with pytest.raises(rec.RecoveryError, match="different tree"):
        tsvc.LodService.restore(to_torch_tree(small_tree), d, device=CPU)


def _fault_disagreeing_halves(ttiny, d):
    s = _port(ttiny, 2, capacity=4)
    s.sync(np.stack([_cam(np.random.default_rng(4)) for _ in range(2)]))
    s.snapshot(d)
    step_dir = os.path.join(d, "step_00000000")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    entry = next(e for e in manifest["leaves"] if e["key"] == "host/active")
    np.save(os.path.join(step_dir, entry["file"]),
            ~np.load(os.path.join(step_dir, entry["file"])))
    with pytest.raises(rec.RecoveryError, match="disagrees"):
        tsvc.LodService.restore(ttiny, d, device=CPU)


def _fault_empty_directory(ttiny, d):
    with pytest.raises(rec.RecoveryError, match="no complete snapshot"):
        tsvc.LodService.restore(ttiny, d, device=CPU)
    with pytest.raises(rec.RecoveryError, match="cannot recover"):
        rec.recover(ttiny, d, device=CPU)


FAULTS = {
    "tmp_leftover": _fault_tmp_leftover,
    "truncated_leaf": _fault_truncated_leaf,
    "corrupt_manifest": _fault_corrupt_manifest,
    "every_snapshot_corrupt": _fault_every_snapshot_corrupt,
    "torn_journal_tail": _fault_torn_journal_tail,
    "journal_midfile_corruption": _fault_journal_midfile_corruption,
    "journal_seq_hole": _fault_journal_seq_hole,
    "wrong_tree": _fault_wrong_tree,
    "disagreeing_halves": _fault_disagreeing_halves,
    "empty_directory": _fault_empty_directory,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_injected_fault(ttiny, small_tree, tmp_path, fault):
    """Each injected fault ends in a bit-exact restore from an earlier
    consistent point or in a typed `RecoveryError`."""
    fn = FAULTS[fault]
    if fault == "wrong_tree":
        fn(ttiny, str(tmp_path), small_tree)
    else:
        fn(ttiny, str(tmp_path))


# ---------------------------------------------------------------------------
# (d) the journal's format
# ---------------------------------------------------------------------------


def test_sync_journal_roundtrip_and_repair(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = rec.SyncJournal(path)
    for k in range(5):
        assert j.append({"kind": "sync", "cams": {"0": [1.0, 2.0, k]}}) == k
    recs = rec.SyncJournal.read(path)
    assert [r["seq"] for r in recs] == list(range(5))
    assert recs[3]["cams"]["0"] == [1.0, 2.0, 3]
    with open(path, "ab") as f:
        f.write(b'{"kind": "syn\xff\xfe')
    assert len(rec.SyncJournal.read(path, repair=True)) == 5
    with open(path, "rb") as f:
        raw = f.read()
    assert raw.endswith(b"\n") and b"\xff" not in raw
    j2 = rec.SyncJournal(path, seq=5)
    j2.append({"kind": "shrink"})
    assert [r["seq"] for r in rec.SyncJournal.read(path)] == list(range(6))
    # the reference reads the port's journal, CRCs and all
    assert jrec.SyncJournal.read(path, repair=False) == rec.SyncJournal.read(path)


def test_sync_journal_cam_roundtrip_is_bitwise(tmp_path):
    cam = _cam(np.random.default_rng(9))
    np.testing.assert_array_equal(cam, np.asarray(rec._jsonable_cam(cam), np.float32))
    assert rec._jsonable_cam(cam) == jrec._jsonable_cam(cam)
    j = rec.SyncJournal(str(tmp_path / "j.jsonl"))
    j.append({"kind": "sync", "cams": {"0": rec._jsonable_cam(cam)}})
    got = np.asarray(rec.SyncJournal.read(j.path)[0]["cams"]["0"], np.float32)
    np.testing.assert_array_equal(cam, got)


def test_replay_unknown_kind_is_typed(ttiny):
    s = _port(ttiny, 1, capacity=4)
    with pytest.raises(rec.RecoveryError, match="unknown journal record"):
        rec.replay(s, [{"kind": "frobnicate", "seq": 0}])


# ---------------------------------------------------------------------------
# (e) across packages
# ---------------------------------------------------------------------------


def _jax(jtree, n, **kw):
    return jsvc.LodService(jtree, JConfig(**CFG), n, focal=FOCAL, **kw)


def _churn_with_nack(ops, service, schedule, log, payload):
    """`schedule`, then an admit and a sync (the newcomer's cold Δcut), a
    NACK of the first page of that stream that lost it rows, a bandwidth
    re-tier of the first client and one more sync of everyone."""
    _play(ops, service, schedule, log, payload)
    cid = service._next_id
    _play(ops, service, [("admit", cid, np.asarray([14.0, 12.0, 2.5], np.float32)),
                         ("sync", {c: _cam(np.random.default_rng(c))
                                   for c in service.active_ids + [cid]})], log, payload)
    pages = int(np_(service.last_delta.pages))
    page = next(p for p in range(pages) if len(service.resolve_nack(cid, [p])))
    assert ops.nack(cid, [page]) > 0
    ops.set_bandwidth(service.active_ids[0], 5000.0)
    _play(ops, service, [("sync", {c: _cam(np.random.default_rng(c + 9))
                                   for c in service.active_ids})], log, payload)


def test_jax_journal_recovered_by_the_port(tiny_tree, ttiny, tmp_path):
    """(a) A run journaled by JAX's `RecoveryManager` (admits growing the
    slots, evicts, a NACK, a re-tier), crashed with a journal tail after
    its newest snapshot, is recovered by the port's `recover` and goes on
    equal to the uninterrupted JAX service: ids, counts, flags and
    `sync_bytes` bit for bit, every state leaf and host mirror."""
    schedule = _gen_schedule(np.random.default_rng(72), steps=7, start_clients=2,
                             max_clients=5)
    cut = len(schedule) - 3
    oracle = _jax(tiny_tree, 2, capacity=2, dedup=True)
    victim = _jax(tiny_tree, 2, capacity=2, dedup=True)
    mgr = jrec.RecoveryManager(victim, str(tmp_path), every=3, keep=2)
    log_o, log_v = {}, {}
    _churn_with_nack(oracle, oracle, schedule[:cut], log_o, "ids")
    _churn_with_nack(mgr, victim, schedule[:cut], log_v, "ids")
    kinds = [r["kind"] for r in jrec.SyncJournal.read(os.path.join(str(tmp_path),
                                                                   jrec.JOURNAL_NAME))]
    assert {"admit", "evict", "nack", "bandwidth"} <= set(kinds)
    del victim, mgr  # crash

    mgr2, replayed = rec.recover(ttiny, str(tmp_path), device=CPU)
    records = rec.SyncJournal.read(mgr2.journal.path)
    assert {"sync", "nack"} <= {r["kind"] for r in records[len(records) - replayed:]}
    assert mgr2.saved_mesh is None
    _assert_on(mgr2.service, "cpu")
    _assert_services_bitwise(mgr2.service, oracle, "jax->port recover")
    mgr2.service.codec = to_torch_codec(oracle.codec)
    log_r = _play(mgr2, mgr2.service, schedule[cut:], payload="ids")
    log_o = _play(oracle, oracle, schedule[cut:], payload="ids")
    _assert_logs_equal(log_r, log_o, "jax->port")
    _assert_services_bitwise(mgr2.service, oracle, "jax->port final")


def test_port_journal_recovered_by_jax(tiny_tree, ttiny, tmp_path):
    """(b) A run journaled by the port's `RecoveryManager` is recovered by
    JAX's unchanged `recover` and goes on equal to the uninterrupted port
    service."""
    schedule = _gen_schedule(np.random.default_rng(72), steps=7, start_clients=2,
                             max_clients=5)
    cut = len(schedule) - 3
    oracle = _port(ttiny, 2, capacity=2, dedup=True)
    victim = _port(ttiny, 2, capacity=2, dedup=True)
    mgr = rec.RecoveryManager(victim, str(tmp_path), every=3, keep=2)
    _churn_with_nack(oracle, oracle, schedule[:cut], {}, "ids")
    _churn_with_nack(mgr, victim, schedule[:cut], {}, "ids")
    del victim, mgr

    jmgr, replayed = jrec.recover(tiny_tree, str(tmp_path))
    records = rec.SyncJournal.read(jmgr.journal.path)
    assert {"sync", "nack"} <= {r["kind"] for r in records[len(records) - replayed:]}
    _assert_services_bitwise(jmgr.service, oracle, "port->jax recover", mirror_dtypes=False)
    log_j = _play(jmgr, jmgr.service, schedule[cut:], payload="ids")
    log_o = _play(oracle, oracle, schedule[cut:], payload="ids")
    _assert_logs_equal(log_j, log_o, "port->jax")
    _assert_services_bitwise(jmgr.service, oracle, "port->jax final", mirror_dtypes=False)


def test_snapshots_of_one_state_are_the_same_files(tiny_tree, ttiny, tmp_path):
    """(c) The same script on both packages (a growth, an evict, foveated
    τs, a bandwidth tier, carried debt), then a snapshot by each: equal
    manifests and leaf files identical byte for byte."""
    kw = dict(capacity=2, dedup=True, delta_budget=64, page_size=16, taus=[20.0, 28.0])
    js, ts = _jax(tiny_tree, 2, **kw), _port(ttiny, 2, **kw)
    rng = np.random.default_rng(17)
    for s in (js, ts):
        s.set_bandwidth(1, "phone")
    for step in range(3):
        cams = {c: _cam(rng) for c in js.active_ids}
        if step == 1:
            cam = _cam(rng)
            assert js.admit(cam, tau=30.0) == ts.admit(cam, tau=30.0)
            js.evict(0)
            ts.evict(0)
            cams = {c: _cam(rng) for c in js.active_ids}
        js.sync(cams)
        ts.sync(cams)
    assert bool(ts.state.pending.any()) and ts.capacity == 4
    js.snapshot(str(tmp_path / "jax"), step=5, journal_seq=5)
    ts.snapshot(str(tmp_path / "port"), step=5, journal_seq=5)
    a, b = tmp_path / "jax" / "step_00000005", tmp_path / "port" / "step_00000005"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    assert json.loads((a / "manifest.json").read_text()) == json.loads(
        (b / "manifest.json").read_text())
    for name in sorted(os.listdir(a)):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


class _Clock:
    """Scripted monotonic clock: +1 ms a read."""

    def __init__(self, t0: float = 100.0):
        self.t = float(t0)

    def __call__(self) -> float:
        self.t += 1e-3
        return self.t


def test_jax_scheduler_state_loads_into_the_port(tiny_tree, ttiny, tmp_path):
    """(d) JAX's `RecoveryManager` journals partial ticks and carries its
    `DeadlineScheduler.state_dict()` in a snapshot's extras. The port
    recovers the run, loads that state into its scheduler, and its next
    ticks equal those of JAX's own recovery: selections, stamped columns,
    stats and state."""
    js = _jax(tiny_tree, 3, capacity=4, dedup=True)
    rng = np.random.default_rng(8)
    sched = jsch.DeadlineScheduler(js, default_deadline_ms=42.0, tick_budget_ms=3.0,
                                   clock=_Clock())
    sched.set_deadline(1, 2.5)
    sched.cost.alpha, sched.cost.beta = 0.5, 0.25
    man = jrec.RecoveryManager(js, str(tmp_path), every=16, scheduler=sched)
    pos = rng.uniform([2, 2, 1], [28, 28, 6], (3, 3)).astype(np.float32)
    man.sync(pos)
    man.sync({0: pos[0] + 2.0}, participate=[0])
    man.sync({1: pos[1] + 2.0, 2: pos[2] + 1.0}, participate=[1, 2])
    man.snapshot_now()
    man.sync({0: pos[0] + 4.0}, participate=[0])
    del js, man, sched

    jmgr, j_replayed = jrec.recover(tiny_tree, str(tmp_path))
    tmgr, t_replayed = rec.recover(ttiny, str(tmp_path), device=CPU)
    assert j_replayed == t_replayed == 1
    assert tmgr.scheduler_state == jmgr.scheduler_state is not None
    tmgr.service.codec = to_torch_codec(jmgr.service.codec)
    _assert_services_bitwise(tmgr.service, jmgr.service, "recovered", mirror_dtypes=False)
    jsched = jsch.DeadlineScheduler(jmgr.service, clock=_Clock(200.0))
    tsched = tsch.DeadlineScheduler(tmgr.service, clock=_Clock(200.0))
    jsched.load_state_dict(jmgr.scheduler_state)
    tsched.load_state_dict(tmgr.scheduler_state)
    assert tsched.state_dict() == jsched.state_dict()
    motion = np.random.default_rng(4)
    for t in range(4):
        for cid in [c for c in range(3) if motion.random() < 0.7]:
            p = motion.uniform([2, 2, 1], [28, 28, 6]).astype(np.float32)
            jsched.observe_motion(cid, p)
            tsched.observe_motion(cid, p)
        assert tsched.select() == jsched.select(), t
        tst, jst = tsched.tick(), jsched.tick()
        assert (tst is None) == (jst is None), t
        if tst is not None:
            assert_states_equal(tst, jst, f"tick {t}")
            _assert_services_bitwise(tmgr.service, jmgr.service, f"tick {t}",
                                     mirror_dtypes=False)
    assert tsched.state_dict() == jsched.state_dict()


def test_jax_snapshot_under_a_1x1_mesh_restores_into_the_port(tiny_tree, ttiny, tmp_path):
    """A snapshot JAX took under a 1×1 serving mesh restores onto the
    port's one device and replays as JAX's meshless restore of it does;
    `recover` reports the saved mesh."""
    from repro.launch.mesh import make_fleet_mesh
    cams = np.stack([_cam(np.random.default_rng(8)) for _ in range(2)])
    s = _jax(tiny_tree, 2, capacity=4, mesh=make_fleet_mesh(1, 1))
    mgr = jrec.RecoveryManager(s, str(tmp_path), every=1)
    mgr.sync(cams)
    snap = os.path.join(str(tmp_path), rec.SNAPSHOT_DIRNAME)
    assert ckpt.read_extras(snap, 1)["mesh"] == [["clients", 1], ["slabs", 1]]
    plain = jsvc.LodService.restore(tiny_tree, snap)
    port = tsvc.LodService.restore(ttiny, snap, device=CPU)
    _assert_services_bitwise(port, plain, "restored", mirror_dtypes=False)
    for k in range(2):
        st_t, st_j = port.sync(cams), plain.sync(cams)
        assert_states_equal(st_t, st_j, f"sync {k}")
        assert_states_equal(port.state, plain.state, f"sync {k}")
    mgr2, replayed = rec.recover(ttiny, str(tmp_path), device=CPU)
    assert replayed == 0 and mgr2.saved_mesh == [["clients", 1], ["slabs", 1]]
    _assert_services_bitwise(mgr2.service, s, "recover")


def test_restore_onto_the_requested_device(ttiny, tmp_path):
    """Every restored tensor is on the requested device, the controller's
    carried bytes included."""
    s = _port(ttiny, 2, capacity=4, bandwidth=[3000.0, None])
    s.sync(np.stack([_cam(np.random.default_rng(6)) for _ in range(2)]))
    s.snapshot(str(tmp_path))
    r = tsvc.LodService.restore(ttiny, str(tmp_path), device=CPU)
    _assert_on(r, "cpu")
    assert isinstance(r._active, np.ndarray) and r.device == torch.device("cpu")
    _assert_services_bitwise(r, s, "restored")


def test_recovery_journals_partial_ticks_and_carries_scheduler_state(ttiny, tmp_path):
    """Partial syncs journal stable client ids and replay; the scheduler's
    `state_dict` rides in the snapshot's extras and loads into a scheduler
    around the recovered service (mirrors `tests/test_scheduler.py`'s
    recovery test)."""
    service = _port(ttiny, 3, capacity=4, dedup=True)
    sched = tsch.DeadlineScheduler(service, default_deadline_ms=42.0, clock=_Clock())
    man = rec.RecoveryManager(service, str(tmp_path), every=16, scheduler=sched)
    pos = np.random.default_rng(8).uniform([2, 2, 1], [28, 28, 6], (3, 3)).astype(np.float32)
    man.sync(pos)
    man.sync({0: pos[0] + 2.0}, participate=[0])
    man.sync({1: pos[1] + 2.0, 2: pos[2] + 1.0}, participate=[1, 2])
    man.snapshot_now()
    man.sync({0: pos[0] + 4.0}, participate=[0])
    assert rec.SyncJournal.read(man.journal.path)[-1]["participate"] == [0]

    man2, replayed = rec.recover(ttiny, str(tmp_path), device=CPU)
    assert replayed == 1
    _assert_services_bitwise(man2.service, man.service, "recovered")
    assert man2.scheduler_state == sched.state_dict()
    sched2 = tsch.DeadlineScheduler(man2.service, clock=_Clock())
    sched2.load_state_dict(man2.scheduler_state)
    assert sched2.default_deadline_ms == 42.0
    assert sched2.cost.alpha == sched.cost.alpha
