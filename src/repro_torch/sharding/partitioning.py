"""Sharding rules: logical axis names → mesh axes. Port of
`repro.sharding.partitioning` (the rules and the one divisibility rule;
`make_shardings` goes with the LM families).

A spec is a tuple with one entry a dimension, as JAX's `PartitionSpec`
holds it: None (replicated), one mesh axis name, or a tuple of names. An
axis whose size does not divide its dimension falls back to replicated,
never to a partial split, so one rule table serves every shape.

A mesh here is anything with `axis_names` (a tuple) and `shape` (a dict of
axis name → size), as `jax.sharding.Mesh` has them: the port's
`sharding.fleet.FleetMesh`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def logical_to_pspec(logical: Tuple[Optional[str], ...], mesh,
                     shape: Optional[Tuple[int, ...]] = None,
                     rules: Optional[Dict[str, Tuple[str, ...]]] = None) -> Spec:
    """The spec (a tuple, one entry a dimension) of a leaf whose dimensions
    carry the `logical` names, on `mesh`."""
    rules = rules or LOGICAL_RULES
    names = set(mesh.axis_names)
    sizes = dict(mesh.shape)
    spec = []
    for i, name in enumerate(logical):
        if name is None:
            spec.append(None)
            continue
        axes = axes_for_dim(name, None if shape is None else shape[i],
                            rules, mesh_names=names, mesh_sizes=sizes)
        spec.append(_spec_entry(axes))
    return tuple(spec)


def to_placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements of `spec` on `mesh`: one a mesh axis,
    `Shard(dim)` where a dimension splits over it, else `Replicate()`. A
    spec that splits two dimensions over one axis raises."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dims = [i for i, entry in enumerate(spec)
                if axis in ((entry,) if isinstance(entry, str) else (entry or ()))]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} splits dims {dims} over one axis {axis!r}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)
