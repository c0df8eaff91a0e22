"""Multi-rank harness of the serving-mesh tests: gloo ranks on the CPU,
one process a rank, started from a `file://` store (no TCP port, so test
workers side by side never collide).

numpy and torch only: the ranks import this module, never JAX. The parent
test writes the scene (the JAX package's tree and codec, as arrays) with
`save_scene`, starts the ranks with `run_ranks`, and reads rank 0's
results; the jobs below take `mesh=None` too, so the parent replays the
same script meshless as the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import convert, pytree
from repro_torch.core.camera import StereoRig, make_camera
from repro_torch.core.pipeline import SessionConfig
from repro_torch.serve import lod_service as svc
from repro_torch.sharding import fleet as shd

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
FOCAL = 1400.0
STATS = ("cut_size", "delta_size", "sync_bytes", "unique_delta", "dedup_bytes_saved",
         "nodes_touched", "resweeps", "client_resident", "overflow", "delta_overflow",
         "delta_shipped", "delta_deferred", "pages")
GAUSS = ("mu", "log_scale", "quat", "opacity", "sh")
CODEC_FIELDS = ("codebook", "pos_lo", "pos_hi", "scale_lo", "scale_hi")
RANK_TIMEOUT_S = 300


# -- scene --------------------------------------------------------------------


def save_scene(workdir, tree_arrays: dict, tree_meta: dict, codec_arrays: dict) -> None:
    """Write a tree and a codec (numpy arrays and the tree's meta) where the
    ranks read them."""
    np.savez(Path(workdir) / "scene.npz",
             **{f"tree/{k}": v for k, v in tree_arrays.items()},
             **{f"codec/{k}": v for k, v in codec_arrays.items()})
    (Path(workdir) / "scene.json").write_text(json.dumps(tree_meta))


def load_scene(workdir):
    """(tree, codec) on the CPU, from `save_scene`'s files."""
    z = np.load(Path(workdir) / "scene.npz")
    meta = json.loads((Path(workdir) / "scene.json").read_text())
    tree = convert.tree_from_arrays({k[5:]: z[k] for k in z.files if k.startswith("tree/")},
                                    meta, device=CPU)
    codec = convert.codec_from_arrays({f: z[f"codec/{f}"] for f in CODEC_FIELDS}, CPU)
    return tree, codec


# -- ranks --------------------------------------------------------------------

_RANK_MAIN = r"""
import sys
sys.path[:0] = [{src!r}, {tests!r}]
import _torch_mesh
_torch_mesh.rank_main(*sys.argv[1:])
"""


def run_ranks(workdir, job: str, clients: int, slabs: int,
              timeout: float = RANK_TIMEOUT_S) -> dict:
    """Run `job` on a clients×slabs gloo mesh, one process a rank, and
    return rank 0's results (`load_results`). A rank that fails, or ranks
    not done `timeout` s after their start, fail the run (every rank is
    killed)."""
    world = clients * slabs
    store = Path(workdir) / f"store_{job}_{clients}x{slabs}"
    code = _RANK_MAIN.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    # each rank writes to a file, not a pipe: a full pipe would stall a rank
    # while the parent waits on another
    logs = [Path(workdir) / f"{job}_{clients}x{slabs}_rank{r}.log" for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, str(r), str(world), str(store), str(workdir), job,
                 str(clients), str(slabs)], stdout=out, stderr=subprocess.STDOUT, env=env,
                cwd=str(ROOT)))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log.read_text()[-3000:]) for r, (p, log) in
           enumerate(zip(procs, logs)) if p.returncode != 0]
    assert not bad, bad
    return load_results(workdir, f"{job}_{clients}x{slabs}")


def rank_main(rank, world, store, workdir, job, clients, slabs) -> None:
    from repro_torch.launch.mesh import destroy_fleet_group, init_fleet_group, make_fleet_mesh
    torch.set_num_threads(1)
    init_fleet_group(store, int(rank), int(world), "gloo", device=CPU)
    try:
        mesh = make_fleet_mesh(int(clients), int(slabs), device=CPU)
        out = JOBS[job](workdir, mesh)
        if int(rank) == 0:
            save_results(workdir, f"{job}_{clients}x{slabs}", out)
    finally:
        destroy_fleet_group()


def save_results(workdir, name: str, out: dict) -> None:
    arrays = {k: np.asarray(v) for k, v in out.items() if not isinstance(v, (dict, str))}
    np.savez(Path(workdir) / f"{name}.npz", **arrays)
    extra = {k: v for k, v in out.items() if isinstance(v, (dict, str))}
    (Path(workdir) / f"{name}.json").write_text(json.dumps(extra))


def load_results(workdir, name: str) -> dict:
    z = np.load(Path(workdir) / f"{name}.npz")
    out = {k: z[k] for k in z.files}
    out.update(json.loads((Path(workdir) / f"{name}.json").read_text()))
    return out


# -- the scripts --------------------------------------------------------------


def np_(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def schedule(steps: int = 7):
    """The admit/evict/sync schedule of the reference's mesh parity test
    (`tests/test_sharding_fleet.py`): ids are monotone, so one host schedule
    drives every service."""
    r = np.random.default_rng(5)
    alive, nid = [0, 1, 2, 3], 4
    pos = {c: r.uniform([2, 2, 1], [28, 28, 6]).astype(np.float32) for c in alive}
    ev = []
    for _ in range(steps):
        if len(alive) > 1 and r.random() < 0.35:
            c = alive.pop(int(r.integers(len(alive))))
            ev.append(("evict", c))
        if len(alive) < 6 and r.random() < 0.5:
            p = r.uniform([2, 2, 1], [28, 28, 6]).astype(np.float32)
            ev.append(("admit", nid, p))
            pos[nid] = p
            alive.append(nid)
            nid += 1
        for c in alive:
            pos[c] = (pos[c] + r.normal(0, 3.0, 3)).astype(np.float32)
        ev.append(("sync", {c: pos[c].copy() for c in alive}))
    return ev


def make(tree, codec, mesh, mode="pooled", n=4, capacity=8, tau=32.0, **kw):
    cfg = SessionConfig(tau=tau, cut_budget=2048)
    s = svc.LodService(tree, cfg, n, focal=FOCAL, capacity=capacity, mode=mode, dedup=True,
                       device=CPU, mesh=mesh, **kw)
    s.codec = codec
    return s


def record(out: dict, tag: str, s, stats, deltas: bool = True) -> None:
    """Every stats column and the cut ids of the whole fleet, and each live
    client's decoded Δ slice, into `out` under `tag`."""
    whole = s.gather_slots(stats)
    for f in STATS:
        out[f"{tag}/{f}"] = np_(getattr(whole, f))
    out[f"{tag}/cut_gids"] = np_(s.gather_slots(s.state.cut_gids))
    if deltas:
        for cid in s.active_ids:
            ids, dec = s.client_delta(cid)
            ids = np_(ids)
            out[f"{tag}/ids/{cid}"] = ids
            for f in GAUSS:
                out[f"{tag}/rows/{cid}/{f}"] = np_(getattr(dec, f))[ids >= 0]


def rig_at(pos):
    pos = np.asarray(pos, np.float32)
    cam = make_camera(pos, pos + np.asarray([10, 10, -0.2], np.float32), focal_px=200.0,
                      width=64, height=48, near=0.25, device=CPU)
    return StereoRig(left=cam, baseline=0.06)


def placement_report(s) -> dict:
    """The service's placement record, checked as the reference checks its
    specs: every slot-axis leaf of the state on `clients` (when the mesh
    splits the capacity), every other leaf replicated, the slab tables on
    `slabs`."""
    pl = s.placements()
    specs = [spec for spec in _leaves(pl["state"])]
    shapes = [tuple(x.shape) for x in pytree.leaves(
        shd.global_shapes(s.state, s.client_shards))]
    for spec, shape in zip(specs, shapes):
        if shape and shape[0] == s.capacity:
            assert spec[0] == "clients", (shape, spec)
        else:
            assert spec == (), (shape, spec)
    if s.tables is not None:
        assert pl["tables"].mu[0] == "slabs", pl["tables"].mu
    return {"state": [list(map(str, sp)) for sp in specs]}


def _leaves(spec_tree):
    out = []

    def walk(t):
        if dataclasses.is_dataclass(t):
            for f in dataclasses.fields(t):
                walk(getattr(t, f.name))
        else:
            out.append(t)
    walk(spec_tree)
    return out


def job_parity(workdir, mesh) -> dict:
    """The reference's parity script on one mesh (or none): both schedulers
    over the churn schedule (stats, cuts, Δ rows each sync), the placement
    record, `fleet_totals`, both fallback render paths and a shrink; then
    the paged Δ stream under a tight budget drained to the unbudgeted
    fleet."""
    tree, codec = load_scene(workdir)
    out = {}
    for mode in ("pooled", "vmapped"):
        s = make(tree, codec, mesh, mode)
        n = 0
        for e in schedule():
            if e[0] == "admit":
                assert s.admit(e[2]) == e[1]
            elif e[0] == "evict":
                s.evict(e[1])
            else:
                record(out, f"{mode}/{n}", s, s.sync(dict(e[1])))
                n += 1
        out[f"{mode}/syncs"] = n
        if mesh is not None:
            out[f"{mode}/placement"] = placement_report(s)
        stats = s.sync()
        record(out, f"{mode}/extra", s, stats, deltas=False)
        totals = shd.fleet_totals(stats, mesh, capacity=s.capacity)
        for f in STATS:
            out[f"{mode}/totals/{f}"] = np_(getattr(totals, f))
        rigs = [rig_at(s._slot_cams[s._slot_of(c)]) for c in s.active_ids]
        for path in ("vmap", "pooled"):
            il, ir, _st = s.render_fallback(rigs, list_len=128, max_pairs=1 << 15, path=path)
            out[f"{mode}/render/{path}/L"] = np_(s.gather_slots(il))
            out[f"{mode}/render/{path}/R"] = np_(s.gather_slots(ir))
            if mesh is not None:
                assert il.shape[0] == s.capacity // s.client_shards
        for cid in list(s.active_ids)[:-2]:
            s.evict(cid)
        assert s.maybe_shrink() == 2
        pos = {c: np.asarray([12.0 + c, 9.0, 2.0], np.float32) for c in s.active_ids}
        record(out, f"{mode}/shrunk", s, s.sync(dict(pos)))
        out[f"{mode}/shrunk_shards"] = s.client_shards
    # the paged stream: a tight budget pages the cold union, and the debt
    # drains to the unbudgeted fleet's bits
    am = make(tree, codec, mesh)
    tp = make(tree, codec, mesh, delta_budget=32, page_size=16)
    pos = np.asarray([[8.0, 8.0, 2.0], [20.0, 9.0, 2.5], [10.0, 22.0, 3.0],
                      [24.0, 24.0, 2.0]], np.float32)
    n = 0
    record(out, f"paged/{n}", tp, tp.sync(pos))
    am.sync(pos)
    if mesh is not None:
        pl = tp.placements()["last_delta"]
        assert pl.payload.pos_q[0] == "slabs", pl.payload.pos_q
        assert pl.ref_mask[0] == "clients", pl.ref_mask
        assert tp.last_delta.payload_shards == mesh.size("slabs")
    while bool(tp.gather_slots(tp.state.pending).any()) and n < 64:
        n += 1
        record(out, f"paged/{n}", tp, tp.sync(pos))
        am.sync(pos)
    assert not bool(tp.gather_slots(tp.state.pending).any())
    assert torch.equal(tp.gather_slots(tp.state.mgr.client_has),
                       am.gather_slots(am.state.mgr.client_has))
    out["paged/syncs"] = n + 1
    return out


LO, HI = np.asarray([2, 2, 1], np.float32), np.asarray([28, 28, 6], np.float32)


def roll(s, steps: int = 2) -> dict:
    """Two more syncs of a service at seeded positions: the stats columns,
    then the cut ids and the management tables of the whole fleet."""
    r = np.random.default_rng(77)
    out = {}
    for k in range(steps):
        cams = {c: r.uniform(LO, HI).astype(np.float32) for c in s.active_ids}
        whole = s.gather_slots(s.sync(cams))
        for f in STATS:
            out[f"{k}/{f}"] = np_(getattr(whole, f))
    out["cut_gids"] = np_(s.gather_slots(s.state.cut_gids))
    out["client_has"] = np_(s.gather_slots(s.state.mgr.client_has))
    return out


def churned(tree, codec, mesh):
    """A churned fleet: 4 seats of 8, two syncs with an admit and an evict
    between them."""
    s = make(tree, codec, mesh)
    r = np.random.default_rng(21)
    s.sync(r.uniform(LO, HI, (4, 3)).astype(np.float32))
    s.admit(np.asarray([14.0, 14.0, 3.0], np.float32))
    s.evict(1)
    s.sync({c: r.uniform(LO, HI).astype(np.float32) for c in s.active_ids})
    return s


def _prefixed(tag: str, d: dict) -> dict:
    return {f"{tag}/{k}": v for k, v in d.items()}


def job_snapshot(workdir, mesh) -> dict:
    """The reference's resize-restore script: a churned fleet snapshotted
    under `mesh` and rolled on (`want`); the snapshot restored onto every
    target mesh this world can form and onto none, each rolled the same
    way; then a journaled run from it, recovered onto the rebalanced mesh."""
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.serve import recovery as rec
    tree, codec = load_scene(workdir)
    s = churned(tree, codec, mesh)
    snap = str(Path(workdir) / "snap_mesh")
    s.snapshot(snap)
    out = _prefixed("want", roll(s))
    targets = {"rebalanced_2x4": make_fleet_mesh(2, 4, device=CPU),
               "bigger_8x1": make_fleet_mesh(8, 1, device=CPU), "none": None}
    for name, target in targets.items():
        out.update(_prefixed(name, _restored_roll(tree, codec, snap, target)))
    work = str(Path(workdir) / "journaled")
    v = svc.LodService.restore(tree, snap, device=CPU, mesh=mesh)
    v.codec = codec
    mgr = rec.RecoveryManager(v, work, every=2, keep=2)
    r3 = np.random.default_rng(5)
    for _ in range(3):
        mgr.sync({c: r3.uniform(LO, HI).astype(np.float32) for c in v.active_ids})
    del v, mgr
    m_mesh, replayed = rec.recover(tree, work, device=CPU, mesh=targets["rebalanced_2x4"])
    assert m_mesh.saved_mesh == shd.mesh_signature(mesh)
    out["recovered_replayed"] = replayed
    out.update(_prefixed("recovered", roll(m_mesh.service)))
    return out


def _restored_roll(tree, codec, snap, mesh) -> dict:
    r = svc.LodService.restore(tree, snap, device=CPU, mesh=mesh)
    r.codec = codec
    if mesh is not None and r.client_shards > 1:
        placement_report(r)
    return roll(r)


def job_restore_small(workdir, mesh) -> dict:
    """`job_snapshot`'s snapshot restored onto a smaller mesh."""
    tree, codec = load_scene(workdir)
    return _prefixed("smaller_2x1", _restored_roll(tree, codec,
                                                   str(Path(workdir) / "snap_mesh"), mesh))


def job_partial(workdir, mesh) -> dict:
    """The reference's partial-sync mesh script: lockstep and partial ticks
    on the mesh equal a meshless lockstep fleet; a partial tick leaves the
    slots that sat out bitwise untouched and keeps the placement."""
    tree, codec = load_scene(workdir)
    lock, part, plain = make(tree, codec, mesh), make(tree, codec, mesh), make(tree, codec, None)

    def eq(a, b, tag):
        for x, y in zip(pytree.leaves(a), pytree.leaves(b)):
            assert torch.equal(x, y), tag

    pos = np.random.default_rng(5).uniform(LO, HI, (4, 3)).astype(np.float32)
    for t in range(3):
        mask = part.active_ids if t % 2 == 0 else np.ones(8, bool)
        sl = lock.sync(pos)
        sp = part.sync(pos, participate=mask)
        s0 = plain.sync(pos, participate=np.ones(8, bool))
        eq(sl, sp, f"stats {t}")
        eq(lock.gather_slots(sl), s0, f"stats vs meshless {t}")
        eq(lock.state, part.state, f"state {t}")
        eq(lock.gather_slots(lock.state), plain.state, f"state vs meshless {t}")
        pos = (pos + np.random.default_rng(t).normal(0, 2.0, (4, 3))).astype(np.float32)
    before = part.gather_slots(part.state)
    sp = part.gather_slots(part.sync({0: pos[0] + 5.0}, participate=[0]))
    for x, y in zip(pytree.leaves(part.gather_slots(part.state)), pytree.leaves(before)):
        if x.dim() >= 1 and x.shape[0] == 8:
            assert torch.equal(x[1:], y[1:])
    assert not bool(sp.resweeps[1:].any()) and not bool(sp.sync_bytes[1:].any())
    assert bool(sp.resweeps[0] > 0)
    placement_report(part)
    return {"ok": np.asarray(True)}


def job_collectives(workdir, mesh) -> dict:
    """The collective helpers on known blocks: every dtype all-gathered bit
    for bit, whole trees from blocks, one row from its owner, a rank's
    participation bits, fleet totals and a reduced flag."""
    i, j = mesh.coords
    k = mesh.size("clients")
    whole = {"f": torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3) / 7.0,
             "h": (torch.arange(8, dtype=torch.float32) / 3.0).to(torch.float16),
             "b": torch.arange(8) % 3 == 0, "q": -torch.arange(8, dtype=torch.int16)}
    per = 8 // k
    mine = {n: x[i * per:(i + 1) * per] for n, x in whole.items()}
    got = shd.all_gather_blocks(mesh, "clients", list(mine.values()))
    for (n, x), g in zip(whole.items(), got):
        assert g.dtype == x.dtype and torch.equal(g.reshape(x.shape), x), n
    rep = shd.replicate_fleet(mesh, tuple(mine.values()), k)
    assert all(torch.equal(a, b) for a, b in zip(rep, whole.values()))
    assert torch.equal(shd.gather_row(mesh, mine["f"], 5, k), whole["f"][5])
    mask = np.arange(8) % 2 == 1
    assert np.array_equal(shd.shard_participation(mesh, mask), mask[i * per:(i + 1) * per])
    assert np.array_equal(shd.shard_participation(mesh, mask[:3]), mask[:3])
    tot = shd.fleet_totals((mine["f"][:, 0], mine["b"]), mesh, capacity=8)
    assert torch.allclose(tot[0], whole["f"][:, 0].sum(), rtol=1e-6)
    assert tot[1].dtype == torch.int32 and int(tot[1]) == int(whole["b"].sum())
    flag = shd.all_reduce(mesh, "slabs", torch.tensor(j == 1), op=torch.distributed.ReduceOp.MAX)
    assert bool(flag)
    block, n = shd.shard_service_state(mesh, (whole["f"].clone(), torch.tensor(3)))
    assert torch.equal(block, mine["f"]) and int(n) == 3
    assert block.untyped_storage().size() == mine["f"].numel() * 4
    return {"ok": np.asarray(True)}


def job_failed_write(workdir, mesh) -> dict:
    """Rank 0's snapshot write, then its journal repair, fail (injected):
    every rank raises, rank 0 its own error and the others a `RecoveryError`
    naming it, and no rank counts the failed snapshot as taken."""
    from unittest import mock
    from repro_torch.serve import recovery as rec
    tree, codec = load_scene(workdir)
    writer = torch.distributed.get_rank() == 0
    want = OSError if writer else rec.RecoveryError

    def broken(*a, **kw):
        raise OSError("disk full (injected)")

    work = str(Path(workdir) / f"failed_write_{mesh.sizes[0]}x{mesh.sizes[1]}")
    mgr = rec.RecoveryManager(make(tree, codec, mesh), work, every=1, keep=2)
    with mock.patch.object(rec.ckpt, "save", broken) if writer else contextlib.nullcontext():
        try:
            mgr.sync(np.random.default_rng(3).uniform(LO, HI, (4, 3)).astype(np.float32))
        except want as e:
            assert "disk full (injected)" in str(e), e
        else:
            raise AssertionError("a failed snapshot did not raise on this rank")
    assert mgr._since_snapshot == 1
    # the next snapshot works again, on every rank
    mgr.snapshot_now()
    assert mgr._since_snapshot == 0
    with mock.patch.object(rec.SyncJournal, "read", broken) if writer else contextlib.nullcontext():
        try:
            rec.recover(tree, work, device=CPU, mesh=mesh)
        except want as e:
            assert "disk full (injected)" in str(e), e
        else:
            raise AssertionError("a failed journal repair did not raise on this rank")
    return {"ok": np.asarray(True)}


JOBS = {"parity": job_parity, "snapshot": job_snapshot, "restore_small": job_restore_small,
        "partial": job_partial, "collectives": job_collectives,
        "failed_write": job_failed_write}
