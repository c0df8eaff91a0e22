"""The dry-run's stand-ins against the JAX package's, for all ten archs
(mirrors `test_sharding.py::test_make_shardings_cover_all_archs` and
`test_smoke_archs.py`'s `input_specs` and `abstract_params` tests):
`abstract_params` leaf for leaf in key, shape, dtype and logical axes,
`abstract_cache` and `cache_axes`, `input_specs` and
`batch_logical_axes` for every shape cell, and `make_shardings`' specs
against JAX's `logical_to_pspec` on the (1, 1), (16, 16) and (2, 16, 16)
meshes, each side given a mesh stand-in that only names axis sizes.

The port keeps one module a layer, so its leaves are compared with JAX's
through `convert`'s key map: a stacked JAX leaf is the port's layers
stacked, its axes the port's with "layer" in front, its spec the port's
with None in front ("layer" is never split).
"""

import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import model_zoo as jzoo
from repro.models.config import SHAPES as JSHAPES
from repro.models.config import long_context_capable as jlong
from repro.sharding.partitioning import logical_to_pspec as jlogical_to_pspec
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.models import model_zoo
from repro_torch.models.config import SHAPES
from repro_torch.sharding.partitioning import make_shardings
from repro_torch.train import optimizer as opt

MESHES = [((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
_DTYPES = {torch.float32: np.float32, torch.int32: np.int32}


def _keystr(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path)


def _flat(tree, axes: bool = False) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=(lambda t: isinstance(t, tuple)) if axes else None)
    return {_keystr(p): v for p, v in leaves}


def _dtype(t: torch.Tensor):
    return np.dtype(jax.numpy.bfloat16) if t.dtype == torch.bfloat16 else np.dtype(_DTYPES[t.dtype])


@pytest.fixture(scope="module")
def jax_abstract():
    out = {}
    for name in sorted(JARCHS):
        m = jzoo.get_model(JARCHS[name])
        shapes, axes = m.abstract_params()
        out[name] = dict(params=_flat(shapes), axes=_flat(axes, axes=True),
                         cache=_flat(m.abstract_cache(2, 64)),
                         cache_axes=_flat(m.cache_axes(), axes=True),
                         opt_axes=_flat(jopt.state_axes(axes).m, axes=True))
    return out


@functools.lru_cache(maxsize=None)
def _port(name):
    cfg = ARCHS[name]
    bundle = model_zoo.get_model(cfg)
    shapes, axes = bundle.abstract_params()
    cache, cache_axes = bundle.abstract_cache(2, 64)
    return cfg, bundle, shapes, axes, cache, cache_axes


def _port_mesh(shape, names):
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))


def _jax_mesh(shape, names):
    return SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _jax_spec(ax, shape, mesh) -> tuple:
    """JAX's `make_shardings` leaf rule: axes padded with None and cut to
    the rank, then `logical_to_pspec`."""
    ax = tuple(ax or ()) + (None,) * (len(shape) - len(ax or ()))
    return tuple(jlogical_to_pspec(ax[: len(shape)], mesh, tuple(shape)))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_abstract_params_match_jax(name, jax_abstract):
    cfg, _b, shapes, axes, _c, _ca = _port(name)
    ref = jax_abstract[name]
    assert all(t.device.type == "meta" for t in shapes.values())
    stacked = convert.stack_as_jax(shapes, cfg)
    jaxes = convert.axes_as_jax(axes, cfg)
    assert sorted(stacked) == sorted(ref["params"]) == sorted(jaxes) == sorted(ref["axes"])
    for key, t in stacked.items():
        theirs = ref["params"][key]
        assert tuple(t.shape) == tuple(theirs.shape), key
        assert _dtype(t) == np.dtype(theirs.dtype), key
        assert jaxes[key] == tuple(ref["axes"][key]), key
    opt_axes = convert.axes_as_jax(opt.state_axes(axes).m, cfg)
    assert opt_axes == {k: tuple(v) for k, v in ref["opt_axes"].items()}
    assert opt.state_axes(axes).step == ()


def test_abstract_params_no_allocation():
    """mistral-large-123b on the meta device: every leaf meta, > 100e9."""
    _cfg, _b, shapes, axes, _c, _ca = _port("mistral-large-123b")
    assert all(t.device.type == "meta" for t in shapes.values())
    assert sum(t.numel() for t in shapes.values()) > 100e9
    assert sorted(shapes) == sorted(axes)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_abstract_cache_and_axes_match_jax(name, jax_abstract):
    cfg, _b, _s, _a, cache, cache_axes = _port(name)
    ref = jax_abstract[name]
    stacked = convert.cache_as_jax(cache, cfg)
    jaxes = convert.cache_as_jax(cache_axes, cfg, like=cache)
    assert sorted(stacked) == sorted(ref["cache"]) == sorted(jaxes) == sorted(ref["cache_axes"])
    for key, t in stacked.items():
        theirs = ref["cache"][key]
        assert t.device.type == "meta", key
        assert tuple(t.shape) == tuple(theirs.shape), key
        assert _dtype(t) == np.dtype(theirs.dtype), key
        assert jaxes[key] == tuple(ref["cache_axes"][key]), key


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_input_specs_match_jax(name):
    cfg, jcfg = ARCHS[name], JARCHS[name]
    assert [s.name for s in SHAPES] == [s.name for s in JSHAPES]
    for shape, jshape in zip(SHAPES, JSHAPES):
        if shape.name == "long_500k" and not jlong(jcfg):
            continue
        specs = model_zoo.input_specs(cfg, shape)
        jspecs = jzoo.input_specs(jcfg, jshape)
        assert sorted(specs) == sorted(jspecs), shape.name
        assert "tokens" in specs or "token" in specs
        for key, t in specs.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(jspecs[key].shape), (shape.name, key)
            assert _dtype(t) == np.dtype(jspecs[key].dtype), (shape.name, key)
        assert model_zoo.batch_logical_axes(cfg, shape) == jzoo.batch_logical_axes(jcfg, jshape)


@pytest.mark.parametrize("mesh_shape,names", MESHES)
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_make_shardings_match_jax(name, mesh_shape, names, jax_abstract):
    cfg, _b, shapes, axes, cache, cache_axes = _port(name)
    ref = jax_abstract[name]
    mesh, jmesh = _port_mesh(mesh_shape, names), _jax_mesh(mesh_shape, names)
    specs = make_shardings(mesh, shapes, axes)
    for key, parts in convert.jax_layout(specs, cfg).items():
        want = _jax_spec(ref["axes"][key], ref["params"][key].shape, jmesh)
        for port_name, g in parts:
            got = specs[port_name] if g is None else (None,) + specs[port_name]
            assert got == want, (key, port_name, got, want)
    cspecs = make_shardings(mesh, cache, cache_axes)
    assert cspecs["pos"] is None
    for path, key, g in convert.cache_leaf_keys(cfg, cache)[1:]:
        spec = cspecs
        for p in path:
            spec = spec[p]
        want = _jax_spec(ref["cache_axes"][key], ref["cache"][key].shape, jmesh)
        got = spec if g is None else (None,) + spec
        assert got == want, (key, path, got, want)
