"""The port's serving mesh (`repro_torch.sharding.fleet`, `LodService(mesh=)`,
`resize_mesh`, restore onto a mesh), mirroring `tests/test_sharding_fleet.py`
and the mesh tests of `tests/test_fleet_recovery.py`:

  * parity: on a 4×2 mesh of gloo ranks on the CPU (8 processes, started
    from a `file://` store), the reference's seeded admit/evict/sync
    schedule on both schedulers gives the meshless port's bits in every
    stats column, the cut ids and each client's decoded Δ rows after every
    sync; the same for both fallback render paths, the shrink to 2 slots
    (which the mesh no longer divides: replicated) and the paged Δ stream.
    Rank 0's per-sync stats equal the JAX meshless service's; the placement
    records hold `clients` and `slabs` where the reference's specs do;
    `fleet_totals`' integers are exact, its floats within rtol 1e-6;
  * the 1×1 mesh in this process (a world of one gloo rank): the placement
    records against the reference's, a live `resize_mesh` onto it and
    back, a restore onto it;
  * resize on restore: a snapshot taken on 4×2 restores onto 2×4, 8×1, 2×1
    and no mesh, each continuing with the uninterrupted service's bits; its
    files are the meshless port's byte for byte apart from the manifest's
    `"mesh"`; JAX's `restore_service` reads it; a journaled run recovers
    onto 2×4 as the meshless recovery does.

Each multi-rank case bounds its ranks at `_torch_mesh.RANK_TIMEOUT_S`.
"""

import concurrent.futures
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import _torch_mesh as tm
from _torch_parity import CPU, np_
from repro_torch.core import lod_search as tls
from repro_torch.core.pipeline import SessionConfig
from repro_torch.launch.mesh import destroy_fleet_group, init_fleet_group, make_fleet_mesh
from repro_torch.serve import lod_service as tsvc
from repro_torch.sharding import fleet as shd


@pytest.fixture(scope="module")
def mesh_scene(tmp_path_factory):
    """The reference parity script's tree (150 Gaussians, seed 11) and its
    meshless JAX service's codec, written where the ranks read them.
    Returns (workdir, JAX tree)."""
    from _torch_parity import tree_arrays
    from repro.core.gaussians import random_gaussians
    from repro.core.lod_tree import build_lod_tree
    from repro.serve import lod_service as jsvc
    rng = np.random.default_rng(11)
    jtree = build_lod_tree(random_gaussians(rng, 150, sh_degree=1, extent=30.0),
                           branching=(2, 4), target_subtrees=8, seed=1)
    js = jsvc.LodService(jtree, jsvc.SessionConfig(tau=32.0, cut_budget=2048), 4,
                         focal=tm.FOCAL, capacity=8)
    wd = tmp_path_factory.mktemp("mesh_scene")
    arrays, meta = tree_arrays(jtree)
    tm.save_scene(wd, arrays, meta, {k: np_(getattr(js.codec, k)) for k in tm.CODEC_FIELDS})
    return wd, jtree


@pytest.fixture
def mesh11(tmp_path):
    """A 1×1 serving mesh over a world of this one process (gloo)."""
    init_fleet_group(str(tmp_path / "store"), 0, 1, "gloo", device=CPU)
    try:
        yield make_fleet_mesh(1, 1, device=CPU)
    finally:
        destroy_fleet_group()


def _arrays(d: dict) -> dict:
    return {k: v for k, v in d.items() if not isinstance(v, (dict, str))}


def _assert_results_equal(got: dict, want: dict, ctx: str) -> None:
    got, want = _arrays(got), _arrays(want)
    assert sorted(got) == sorted(want), (ctx, sorted(set(got) ^ set(want))[:8])
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, (ctx, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: {k}")


# ---------------------------------------------------------------------------
# (a) the 4×2 parity run (the reference's acceptance contract)
# ---------------------------------------------------------------------------


def _jax_schedule_stats(jtree):
    """Per-sync stats and cut ids of the JAX meshless pooled service over
    the parity schedule."""
    from repro.serve import lod_service as jsvc
    js = jsvc.LodService(jtree, jsvc.SessionConfig(tau=32.0, cut_budget=2048), 4,
                         focal=tm.FOCAL, capacity=8, mode="pooled", dedup=True)
    out, n = {}, 0
    for e in tm.schedule():
        if e[0] == "admit":
            assert js.admit(e[2]) == e[1]
        elif e[0] == "evict":
            js.evict(e[1])
        else:
            st = js.sync(dict(e[1]))
            for f in tm.STATS:
                out[f"{n}/{f}"] = np.asarray(getattr(st, f))
            out[f"{n}/cut_gids"] = np.asarray(js.state.cut_gids)
            n += 1
    return out


def test_sharded_fleet_parity_on_a_4x2_gloo_mesh(mesh_scene):
    wd, jtree = mesh_scene
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(tm.run_ranks, wd, "parity", 4, 2)
        want = tm.job_parity(wd, None)
        jax_stats = _jax_schedule_stats(jtree)
        got = ranks.result()
    totals = {k: v for k, v in _arrays(got).items() if "/totals/" in k}
    rest = {k: v for k, v in got.items() if "/totals/" not in k and "placement" not in k}
    _assert_results_equal(rest, {k: v for k, v in want.items() if "/totals/" not in k},
                          "4x2 vs meshless")
    for k, v in totals.items():
        w = np.asarray(want[k])
        assert v.dtype == w.dtype, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(v, w, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(v, w, err_msg=k)
    for mode in ("pooled", "vmapped"):
        assert int(got[f"{mode}/syncs"]) >= 5
        for k, v in jax_stats.items():
            assert got[f"{mode}/{k}"].dtype == v.dtype, (mode, k)
            np.testing.assert_array_equal(got[f"{mode}/{k}"], v, err_msg=f"{mode} vs JAX {k}")
        # capacity 8 on 4 client shards: every slot-axis leaf on `clients`
        specs = got[f"{mode}/placement"]["state"]
        assert specs and all(sp == [] or sp[0] == "clients" for sp in specs)
        # the shrink to 2 slots: 4 shards no longer divide it (replicated)
        assert int(got[f"{mode}/shrunk_shards"]) == 1
    assert int(got["paged/syncs"]) > 1


# ---------------------------------------------------------------------------
# (b) the 1×1 mesh in this process
# ---------------------------------------------------------------------------


def _spec_leaves(tree) -> list:
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _spec_leaves(getattr(tree, f.name))]
    return [tuple(getattr(tree, "spec", tree))]  # a JAX NamedSharding or a port spec


def test_fleet_shardings_match_the_reference(mesh_scene, mesh11):
    from _torch_parity import to_torch_tree
    from repro.core import lod_search as jls
    from repro.launch.mesh import make_fleet_mesh as jax_fleet_mesh
    from repro.serve import lod_service as jsvc
    from repro.sharding import fleet as jshf
    _wd, jtree = mesh_scene
    tree = to_torch_tree(jtree)
    state = tsvc.service_init(tree, SessionConfig(tau=32.0), 4)
    jstate = jsvc.service_init(jtree, jsvc.SessionConfig(tau=32.0), 4)
    jmesh = jax_fleet_mesh(1, 1)
    sh = shd.fleet_shardings(mesh11, state)
    assert _spec_leaves(sh) == _spec_leaves(jshf.fleet_shardings(jmesh, jstate))
    assert sh.sync_index == ("clients",) and sh.fleet.next_id == ()
    assert sh.temporal.slab_cut0 == ("clients", None, None)
    tables = tls.SlabTables.from_tree(tree)
    tsh = shd.slab_shardings(mesh11, tables)
    assert _spec_leaves(tsh) == _spec_leaves(
        jshf.slab_shardings(jmesh, jls.SlabTables.from_tree(jtree)))
    assert tsh.mu == ("slabs", None, None)
    # placement on the 1×1 mesh keeps every slot: a bitwise no-op
    placed = shd.shard_service_state(mesh11, state)
    assert placed is state
    assert shd.mesh_signature(mesh11) == [["clients", 1], ["slabs", 1]]
    assert shd.shard_resident_bytes(mesh11, state) == shd.shard_resident_bytes(None, state)


def _churn(svc_, rng, steps=2):
    for _ in range(steps):
        yield svc_.sync({c: rng.uniform(tm.LO, tm.HI).astype(np.float32)
                         for c in svc_.active_ids})


def _assert_bitwise(a, b, ctx):
    for (k, x), (_k, y) in zip(tm.pytree.flatten_with_paths(a.state),
                               tm.pytree.flatten_with_paths(b.state)):
        assert torch.equal(x, y), f"{ctx}: {k}"


def test_resize_mesh_live_is_bitwise(mesh_scene, mesh11):
    """A live meshless service moved onto the 1×1 mesh and back keeps the
    trajectory of one that never moved (`test_fleet_recovery.py:504`)."""
    tree, codec = tm.load_scene(mesh_scene[0])
    control, moved = tm.make(tree, codec, None, n=2, capacity=4), \
        tm.make(tree, codec, None, n=2, capacity=4)
    cams = np.random.default_rng(6).uniform(tm.LO, tm.HI, (2, 3)).astype(np.float32)
    for step, target in enumerate((mesh11, None)):
        control.sync(cams)
        moved.sync(cams)
        moved.resize_mesh(target)
        assert moved.mesh is target
        a, b = control.sync(cams + step), moved.sync(cams + step)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
        for cid in (0, 1):
            assert torch.equal(control.client_cut(cid), moved.client_cut(cid))
            ia, da = control.client_delta(cid)
            ib, db = moved.client_delta(cid)
            assert torch.equal(ia, ib) and torch.equal(da.mu, db.mu)
        _assert_bitwise(moved, control, f"step {step}")


def test_restore_onto_mesh_single_device_is_bitwise(mesh_scene, mesh11, tmp_path):
    """Reshard-on-load onto the 1×1 mesh equals the meshless restore, and
    the manifest records the layout it was saved under
    (`test_fleet_recovery.py:528`)."""
    from repro_torch.checkpoint import manager as ckpt
    tree, codec = tm.load_scene(mesh_scene[0])
    s = tm.make(tree, codec, None, n=2, capacity=4)
    cams = np.random.default_rng(8).uniform(tm.LO, tm.HI, (2, 3)).astype(np.float32)
    s.sync(cams)
    s.snapshot(str(tmp_path / "plain"))
    assert ckpt.read_extras(str(tmp_path / "plain"), 0)["mesh"] is None
    plain = tsvc.LodService.restore(tree, str(tmp_path / "plain"), device=CPU)
    meshed = tsvc.LodService.restore(tree, str(tmp_path / "plain"), device=CPU, mesh=mesh11)
    assert meshed.mesh is mesh11 and plain.mesh is None
    for svc_ in (plain, meshed):
        svc_.codec = codec
    a, b = plain.sync(cams), meshed.sync(cams)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    meshed.snapshot(str(tmp_path / "meshed"))
    assert ckpt.read_extras(str(tmp_path / "meshed"), 0)["mesh"] == [["clients", 1],
                                                                     ["slabs", 1]]
    with shd.use_fleet_mesh(mesh11):
        ambient = tm.make(tree, codec, None, n=2, capacity=4)
    assert ambient.mesh is mesh11 and shd.current_fleet_mesh() is None


def test_make_fleet_mesh_needs_a_world_of_its_size(mesh11):
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        make_fleet_mesh(2, 1, device=CPU)
    with pytest.raises(ValueError):
        make_fleet_mesh(0, 1, device=CPU)


def test_make_fleet_mesh_needs_a_process_group():
    if torch.distributed.is_initialized():
        pytest.skip("a process group is up in this worker")
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_fleet_mesh(1, 1, device=CPU)


# ---------------------------------------------------------------------------
# (c) restore onto other meshes (the reference's resize-restore contract)
# ---------------------------------------------------------------------------


def _jax_roll(js) -> dict:
    r = np.random.default_rng(77)
    out = {}
    for k in range(2):
        cams = {c: r.uniform(tm.LO, tm.HI).astype(np.float32) for c in js.active_ids}
        st = js.sync(cams)
        for f in tm.STATS:
            out[f"{k}/{f}"] = np.asarray(getattr(st, f))
    out["cut_gids"] = np.asarray(js.state.cut_gids)
    out["client_has"] = np.asarray(js.state.mgr.client_has)
    return out


def test_mesh_resize_restore(mesh_scene):
    from repro.serve import recovery as jrec
    from repro_torch.serve import recovery as rec
    wd, jtree = mesh_scene
    got = tm.run_ranks(wd, "snapshot", 4, 2)
    small = tm.run_ranks(wd, "restore_small", 2, 1)
    tree, codec = tm.load_scene(wd)
    plain = tm.churned(tree, codec, None)
    plain.snapshot(str(wd / "snap_plain"))
    want = tm.roll(plain)
    _assert_results_equal({k[5:]: v for k, v in got.items() if k.startswith("want/")},
                          want, "4x2 service vs meshless")
    for name, res in (("rebalanced_2x4", got), ("bigger_8x1", got), ("none", got),
                      ("smaller_2x1", small)):
        _assert_results_equal({k[len(name) + 1:]: v for k, v in res.items()
                               if k.startswith(name + "/")}, want, name)
    # the 4×2 snapshot is the meshless one's files, its manifest apart
    a, b = wd / "snap_mesh" / "step_00000000", wd / "snap_plain" / "step_00000000"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    assert ma["extras"].pop("mesh") == [["clients", 4], ["slabs", 2]]
    assert mb["extras"].pop("mesh") is None and ma == mb
    for name in os.listdir(a):
        if name != "manifest.json":
            assert (a / name).read_bytes() == (b / name).read_bytes(), name
    # JAX's own restore reads it and continues with the same bits
    js = jrec.restore_service(jtree, str(wd / "snap_mesh"))
    for k, v in _jax_roll(js).items():
        np.testing.assert_array_equal(v, want[k], err_msg=f"JAX restore: {k}")
    # the journaled run recovered onto 2×4 equals the meshless recovery
    m_none, replayed = rec.recover(tree, str(wd / "journaled"), device=CPU)
    assert replayed == int(got["recovered_replayed"]) > 0
    _assert_results_equal({k[10:]: v for k, v in got.items() if k.startswith("recovered/")},
                          tm.roll(m_none.service), "recover onto 2x4")


def test_a_failed_write_on_rank_0_raises_on_every_rank(mesh_scene):
    """Rank 0 writes the snapshot and repairs the journal for the mesh: when
    either fails, the other ranks raise too instead of going on."""
    wd, _jtree = mesh_scene
    assert bool(tm.run_ranks(wd, "failed_write", 2, 1)["ok"])
