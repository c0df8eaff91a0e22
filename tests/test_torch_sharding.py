"""The port's sharding rules (`repro_torch.sharding.partitioning`, the rule
half of `sharding.fleet`) against the reference's, the collective helpers
of the serving mesh on gloo ranks, and the partial-sync mesh test of
`tests/test_scheduler.py` on a 4×2 mesh.

The rules are held to the JAX functions on every rule and shape of
`tests/test_sharding_fleet.py` and `tests/test_sharding.py`, and on meshes
of several sizes (the reference's functions read only a mesh's axis names
and device grid, so a stand-in with those serves where one CPU device
cannot form the mesh). Specs compare as tuples.
"""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest

import _torch_mesh as tm
from repro_torch.sharding import fleet as shf
from repro_torch.sharding import partitioning as shp
from test_torch_sharding_fleet import mesh_scene  # noqa: F401  (a fixture)


def _mesh(names, sizes):
    """What the rule functions of either package read of a mesh."""
    return SimpleNamespace(axis_names=tuple(names), devices=np.empty(tuple(sizes)),
                           shape=dict(zip(names, sizes)))


_SIZES = {"pod": 2, "data": 3, "model": 4}
_DIM_CASES = [
    ("batch", 12, set(_SIZES), _SIZES), ("batch", 8, set(_SIZES), _SIZES),
    ("batch", 9, {"data"}, {"data": 3}), ("batch", 7, set(_SIZES), None),
    ("batch", 8, set(_SIZES), {"data": 3}), ("nope", 8, set(_SIZES), _SIZES),
    (None, 8, set(_SIZES), _SIZES), ("heads", 64, set(_SIZES), _SIZES),
    ("heads", 6, {"model"}, {"model": 4}), ("heads", None, set(_SIZES), _SIZES)]


@pytest.mark.parametrize("name,dim,names,sizes", _DIM_CASES)
def test_axes_for_dim_matches_the_reference(name, dim, names, sizes):
    """`test_sharding_fleet.py:62`: the one divisibility rule."""
    from repro.sharding import partitioning as jshp
    rules = {"batch": ("pod", "data"), "heads": ("model",)}
    assert shp.axes_for_dim(name, dim, rules, names, sizes) == \
        jshp.axes_for_dim(name, dim, rules, names, sizes)


_MESHES = [(("clients", "slabs"), s) for s in ((1, 1), (4, 2), (2, 4), (8, 1), (2, 1), (3, 2))]
_LOGICAL = [("clients",), ("clients", None), ("clients", None, None), ("slabs", None, None),
            ("union",), ("union", None), ("clients", "union"), (None, "slabs")]
_SHAPES = [(1,), (2,), (4, 3), (8, 5), (6, 6, 2), (16, 8), (7, 9, 3), (24, 32)]


@pytest.mark.parametrize("names,sizes", _MESHES)
def test_fleet_pspec_matches_the_reference(names, sizes):
    """`logical_to_pspec` under the fleet rules (`test_sharding_fleet.py:62,
    :117, :136`) on every logical name and shape, on meshes of several
    sizes, divisible and not."""
    from repro.sharding import fleet as jshf
    from repro.sharding import partitioning as jshp
    mesh = _mesh(names, sizes)
    rules = shf.fleet_axis_rules(mesh)
    assert rules == jshf.fleet_axis_rules(mesh)
    for logical, shape in itertools.product(_LOGICAL, _SHAPES):
        if len(logical) != len(shape):
            continue
        assert shp.logical_to_pspec(logical, mesh, shape, rules) == tuple(
            jshp.logical_to_pspec(logical, mesh, shape, rules)), (sizes, logical, shape)
    for cap in (1, 2, 4, 6, 8, 16):
        assert shf.client_shards(mesh, cap) == jshf.client_shards(mesh, cap), (sizes, cap)


def test_weight_rules_match_the_reference():
    """`test_sharding.py:24` and the weight rule table on a 2×4 data/model
    mesh (divisible and not)."""
    from repro.sharding import partitioning as jshp
    assert shp.LOGICAL_RULES == jshp.LOGICAL_RULES
    for sizes in ((1, 1), (2, 4)):
        mesh = _mesh(("data", "model"), sizes)
        for logical, shape in ((("embed", "heads"), (64, 64)), (("embed", "ffn"), (6, 10)),
                               (("vocab", None), (12, 3)), (("batch", "head_dim_c"), (4, 8))):
            assert shp.logical_to_pspec(logical, mesh, shape) == tuple(
                jshp.logical_to_pspec(logical, mesh, shape)), (sizes, logical, shape)
    assert shp.logical_to_pspec(("embed", "heads"), _mesh(("data", "model"), (1, 1)),
                                (64, 64)) == ("data", "model")


def test_fleet_axis_rules_and_client_shards():
    """`test_sharding_fleet.py:136, :148`."""
    mesh = _mesh(("clients", "slabs"), (1, 1))
    rules = shf.fleet_axis_rules(mesh)
    assert rules["clients"] == ("clients",) and rules["union"] == ("slabs",)
    assert rules["__sizes__"] == {"clients": 1, "slabs": 1}
    lone = shf.fleet_axis_rules(_mesh(("data",), (1,)))
    assert lone["clients"] == () and lone["slabs"] == ()
    assert shf.client_shards(mesh, 8) == 1 and shf.client_shards(None, 8) == 1
    assert shf.client_shards(_mesh(("clients", "slabs"), (4, 2)), 2) == 1
    assert shf.mesh_signature(None) is None


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh(("clients", "slabs"), (4, 2))
    assert shp.to_placements(("clients", None), mesh) == (Shard(0), Replicate())
    assert shp.to_placements(("slabs", None, None), mesh) == (Replicate(), Shard(0))
    assert shp.to_placements((None, "slabs"), mesh) == (Replicate(), Shard(1))
    assert shp.to_placements((), mesh) == (Replicate(), Replicate())
    with pytest.raises(ValueError):
        shp.to_placements(("clients", "clients"), mesh)


def test_fleet_totals_meshless(mesh_scene):
    """`test_sharding_fleet.py:154`: bools count in int32, columns keep
    their types."""
    tree, codec = tm.load_scene(mesh_scene[0])
    s = tm.make(tree, codec, None, n=3, capacity=3)
    stats = s.sync(np.asarray([[5, 5, 2], [9, 7, 2], [20, 15, 3]], np.float32))
    tot = shf.fleet_totals(stats)
    assert int(tot.cut_size) == int(stats.cut_size.sum())
    assert float(tot.sync_bytes) == pytest.approx(float(stats.sync_bytes.sum()))
    assert tot.overflow.dtype == tot.cut_size.dtype == stats.cut_size.dtype
    assert tot.sync_bytes.dtype == stats.sync_bytes.dtype


def test_collectives_on_a_2x2_gloo_mesh(mesh_scene):
    assert bool(tm.run_ranks(mesh_scene[0], "collectives", 2, 2)["ok"])


def test_partial_sync_mesh_parity(mesh_scene):
    """`test_scheduler.py:453` on a 4×2 mesh of gloo ranks: lockstep and
    partial ticks equal a meshless lockstep fleet; a partial tick leaves the
    slots that sat out bitwise untouched."""
    assert bool(tm.run_ranks(mesh_scene[0], "partial", 4, 2)["ok"])
