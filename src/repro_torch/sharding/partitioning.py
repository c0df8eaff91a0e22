"""Sharding rules: logical axis names → mesh axes. Port of
`repro.sharding.partitioning`.

A spec is a tuple with one entry a dimension, as JAX's `PartitionSpec`
holds it: None (replicated), one mesh axis name, or a tuple of names. An
axis whose size does not divide its dimension falls back to replicated,
never to a partial split, so one rule table serves every shape.

A mesh here is a `torch.distributed.DeviceMesh` with named dims
(`launch.mesh.make_mesh`), or anything with `axis_names` (a tuple) and
`shape` (a dict of axis name → size), as `jax.sharding.Mesh` has them: the
port's `sharding.fleet.FleetMesh`, or a stand-in that only names sizes.

`make_shardings` gives a tree of specs for a tree of tensors (or anything
with a `.shape`) and its logical axes; `shard_module` and `shard_tree`
place tensors by them as DTensors, `to_placements` giving each spec's
placements. On the meta device placing allocates nothing: a leaf becomes
its local shard's shape (`local_shape`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

# weight-side logical rules (the LM families' FSDP/TP layout)
LOGICAL_RULES: Dict[str, Tuple[str, ...]] = {
    "layer": (),
    "embed": ("data",),       # FSDP
    "heads": ("model",),      # fused H*hd dim
    "kv_heads": ("model",),   # fused Hkv*hd dim
    "ffn": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "inner": ("model",),      # ssm / xlstm d_inner
    "inner_fsdp": ("data",),  # input dim of square inner projections
    "embed_out": ("model",),  # output dim of square d→d projections
    "ssm_state": (),
    "mheads": ("model",),
    # cache / activation logical names that appear in cache axes trees
    "batch": ("pod", "data"),
    "kv_heads_c": (),
    "head_dim_c": ("model",),
}

Spec = Tuple


def axes_for_dim(name: Optional[str], dim: Optional[int],
                 rules: Dict[str, Tuple[str, ...]],
                 mesh_names=None, mesh_sizes=None) -> Tuple[str, ...]:
    """Mesh axes for one logical dimension: the one divisibility and
    replicate-fallback rule.

      * axes absent from `mesh_names` are dropped (no filter when None);
      * if `dim` is known and every remaining axis has a known size, the
        product of their sizes must divide `dim`, or the whole dimension
        replicates (never a partial split);
      * if any axis size is unknown, divisibility is not enforced.

    Returns the surviving mesh axes, possibly () (replicated)."""
    axes = tuple(rules.get(name, ())) if name is not None else ()
    if mesh_names is not None:
        axes = tuple(a for a in axes if a in mesh_names)
    if not axes:
        return ()
    if dim is not None and mesh_sizes is not None \
            and all(a in mesh_sizes for a in axes):
        div = int(np.prod([mesh_sizes[a] for a in axes]))
        if div and dim % div != 0:
            return ()
    return axes


def _spec_entry(axes: Tuple[str, ...]):
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """(axis names in order, {axis: size}) of a `DeviceMesh` or of a mesh
    with `axis_names` and a `shape` dict."""
    if hasattr(mesh, "mesh_dim_names"):
        names = tuple(mesh.mesh_dim_names)
        return names, dict(zip(names, (int(n) for n in mesh.mesh.shape)))
    return tuple(mesh.axis_names), dict(mesh.shape)


def logical_to_pspec(logical: Tuple[Optional[str], ...], mesh,
                     shape: Optional[Tuple[int, ...]] = None,
                     rules: Optional[Dict[str, Tuple[str, ...]]] = None) -> Spec:
    """The spec (a tuple, one entry a dimension) of a leaf whose dimensions
    carry the `logical` names, on `mesh`."""
    rules = rules or LOGICAL_RULES
    names, sizes = mesh_axes(mesh)
    names = set(names)
    spec = []
    for i, name in enumerate(logical):
        if name is None:
            spec.append(None)
            continue
        axes = axes_for_dim(name, None if shape is None else shape[i],
                            rules, mesh_names=names, mesh_sizes=sizes)
        spec.append(_spec_entry(axes))
    return tuple(spec)


def to_placements(spec: Spec, mesh, shape=None) -> tuple:
    """The DTensor placements of `spec` on `mesh`: one a mesh axis,
    `Shard(dim)` where a dimension splits over it, else `Replicate()`. A
    spec that splits two dimensions over one axis raises. Given the
    tensor's `shape`, a dimension of size 1 (which the rules split only
    over axes of size 1) is replicated instead, the same placement in
    effect: DTensor cannot flatten a split dimension of size 1."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh_axes(mesh)[0]:
        dims = [i for i, entry in enumerate(spec)
                if axis in ((entry,) if isinstance(entry, str) else (entry or ()))]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} splits dims {dims} over one axis {axis!r}")
        whole = not dims or (shape is not None and shape[dims[0]] == 1)
        out.append(Replicate() if whole else Shard(dims[0]))
    return tuple(out)


def make_shardings(mesh, abstract: Any, axes_tree: Any,
                   rules: Optional[Dict[str, Tuple[str, ...]]] = None) -> Any:
    """The spec of every leaf of `abstract` (tensors, or anything with a
    `.shape`), in its structure (dicts, lists, dataclasses). `axes_tree`
    is walked up to `abstract`'s leaves, where it holds each leaf's logical
    axes: padded with None to the leaf's rank and cut to it, as JAX's
    `make_shardings` does. A leaf with no shape (a cache's Python int
    position) has no spec: None."""
    def walk(leaf, ax):
        if isinstance(leaf, dict):
            return {k: walk(leaf[k], ax[k]) for k in leaf}
        if isinstance(leaf, (list, tuple)) and not hasattr(leaf, "shape"):
            return type(leaf)(walk(a, b) for a, b in zip(leaf, ax, strict=True))
        if dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            return dataclasses.replace(leaf, **{
                f.name: walk(getattr(leaf, f.name), getattr(ax, f.name))
                for f in dataclasses.fields(leaf)})
        if not hasattr(leaf, "shape"):
            return None
        rank = len(leaf.shape)
        ax = tuple(ax or ()) + (None,) * (rank - len(ax or ()))
        return logical_to_pspec(ax[:rank], mesh, tuple(leaf.shape), rules)

    return walk(abstract, axes_tree)


def local_shape(shape: Tuple[int, ...], mesh, placements) -> Tuple[int, ...]:
    """A shard's shape: each dimension divided by the sizes of the mesh
    axes that split it (the rules keep every split even)."""
    out = list(shape)
    for size, pl in zip(mesh_axes(mesh)[1].values(), placements):
        if pl.is_shard():
            out[pl.dim] = -(-out[pl.dim] // size)
    return tuple(out)


def place(t, mesh, spec: Spec):
    """`t` as a DTensor on `mesh` (a `DeviceMesh`) split by `spec`. A meta
    tensor becomes a meta shard of the local shape, with no collective;
    any other is split by `distribute_tensor` (on a 1×1 mesh every shard
    is the whole tensor, bit for bit)."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = to_placements(spec, mesh, t.shape)
    if t.device.type != "meta":
        return distribute_tensor(t, mesh, placements)
    local = torch.empty(local_shape(tuple(t.shape), mesh, placements), dtype=t.dtype,
                        device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def shard_tree(tree: Any, mesh, specs: Any) -> Any:
    """Every tensor leaf of `tree` placed by its spec (`make_shardings`):
    an optimizer state or a cache. Leaves without a spec stay as they are."""
    def walk(leaf, spec):
        if isinstance(leaf, dict):
            return {k: walk(leaf[k], spec[k]) for k in leaf}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(walk(a, b) for a, b in zip(leaf, spec, strict=True))
        if dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            return dataclasses.replace(leaf, **{
                f.name: walk(getattr(leaf, f.name), getattr(spec, f.name))
                for f in dataclasses.fields(leaf)})
        return leaf if spec is None else place(leaf, mesh, spec)

    return walk(tree, specs)


def shard_module(module, mesh, specs: Dict[str, Spec]):
    """Replace each parameter of `module` by its DTensor on `mesh`, placed
    by `specs` (parameter name → spec, `make_shardings` of the module's
    parameters). Returns the module."""
    from torch import nn
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        setattr(mod, leaf, nn.Parameter(place(p.detach(), mesh, specs[name]),
                                        requires_grad=p.requires_grad))
    return module
