"""Ambient sharding context: the models stay mesh-agnostic. Port of
`repro.sharding.context`.

Model code calls `constrain(x, ("batch", None, "embed_act"))` with logical
axis names. Torch has no `with_sharding_constraint`, so the port reads it
as a placement:
- with no rules set (`use_rules`), `constrain` and `bshard` return their
  input unchanged, as the reference's do;
- under rules, a DTensor is redistributed to the placements the rules give
  it on its own mesh (`partitioning.to_placements`);
- under rules, a plain tensor is returned unchanged: there is no mesh to
  place it on.

The divisibility rule is `partitioning.axes_for_dim`, the one the weights
use, with the sizes the rules carry in `__sizes__`.

A model placed on a mesh holds DTensors. The primitives whose loops or
kernels DTensor should not place op by op (attention, RoPE, the SSD,
mLSTM and sLSTM scans, MoE's dispatch) run once a shard on local tensors:
`when_placed` routes a call whose first argument is a DTensor to the
primitive's sharded form, and `over_batch_heads` builds that form from the
dims each argument declares. On plain tensors the primitive's own body
runs, after one `isinstance`. The placement helpers at the end
(`gather_seq`, `seq_whole_grad`, `pad_seq`, ...) gather or pad a DTensor
as the models need and return a plain tensor as it is.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import inspect
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.sharding.partitioning import (_spec_entry, axes_for_dim, mesh_axes,
                                               to_placements)

_RULES: contextvars.ContextVar[Optional[Dict[str, Tuple[str, ...]]]] = (
    contextvars.ContextVar("logical_axis_rules", default=None))


def activation_rules(mesh, seq_parallel: bool = True) -> Dict[str, Tuple[str, ...]]:
    """Logical → mesh axes for activations (weights: `partitioning`).

    `mesh` is a `DeviceMesh`, a mesh with `axis_names` and a `shape` dict,
    or a tuple of axis names (sizes then unknown, and divisibility is not
    enforced). `seq_parallel` shards block-boundary activations' seq dim
    over `model`, Megatron-SP style."""
    if hasattr(mesh, "mesh_dim_names") or hasattr(mesh, "axis_names"):
        names, sizes = mesh_axes(mesh)
    else:
        names, sizes = tuple(mesh), {}
    batch = ("pod", "data") if "pod" in names else ("data",)
    return {
        "batch": batch,
        "experts": ("model",),
        "expert_cap": batch,
        "expert_groups": batch,
        "heads_act": ("model",),
        "embed_act": (),          # replicated activations along features
        "ffn_act": ("model",),
        "vocab_act": ("model",),
        "seq_act": ("model",) if seq_parallel else (),
        "__sizes__": sizes,
    }


def current_rules():
    return _RULES.get()


@contextlib.contextmanager
def use_rules(rules: Dict[str, Tuple[str, ...]]):
    token = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(token)


@contextlib.contextmanager
def meshed(rules: Dict[str, Tuple[str, ...]]):
    """`use_rules(rules)`, with plain tensors taken as replicated where they
    meet DTensors (`implicit_replication`: a model's positions, masks and
    scalars): how a module placed on a mesh runs."""
    from torch.distributed.tensor.experimental import implicit_replication
    with use_rules(rules), implicit_replication():
        yield


def per_shard(fn, args: tuple, specs: tuple, out_specs: tuple):
    """`fn(*args)` on DTensors, once a shard (`local_map`): each tensor of
    `args` (flattened as a pytree) is redistributed to its spec in `specs`
    (None: not a tensor) and `fn` runs on the local tensors; the leaves of
    its result take `out_specs`, in order."""
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in pytree.tree_leaves(args) if isinstance(a, DTensor))

    def pl(spec):
        return None if spec is None else list(to_placements(spec, mesh))

    return local_map(fn, out_placements=tuple(pl(s) for s in out_specs),
                     in_placements=tuple(pl(s) for s in specs), device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def batch_heads(t, heads_dim: int = 2) -> Tuple:
    """(the spec entry of `t`'s batch dim, of its heads dim at `heads_dim`)
    under the current rules (or the mesh's own): batch over the data axes,
    heads over `model` where they divide it."""
    rules = current_rules() or activation_rules(t.device_mesh)
    logical = [None] * t.ndim
    logical[0], logical[heads_dim] = "batch", "heads_act"
    spec = logical_spec(t.shape, tuple(logical), rules)
    # a dim of size 1 stays whole (`partitioning.to_placements`)
    return (spec[0] if t.shape[0] > 1 else None,
            spec[heads_dim] if t.shape[heads_dim] > 1 else None)


def when_placed(sharded, key: int = 0):
    """Decorator: a call whose argument `key` (the first by default) is a
    DTensor runs `sharded(fn, *args, **kwargs)`, the primitive `fn`'s form
    for a model placed on a mesh; any other call runs `fn` itself."""
    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if isinstance(args[key], DTensor):
                return sharded(fn, *args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return deco


def _is_dims(d) -> bool:
    return isinstance(d, tuple) and all(x is None or isinstance(x, str) for x in d)


def _dims_specs(val, dims, entry) -> list:
    """One spec a pytree leaf of `val`: each tensor's declared `dims`
    ("batch", "heads" or None each; a tuple of such for a tuple of
    tensors) mapped through `entry`; None for the rest."""
    if dims is None or val is None:
        return [None] * len(pytree.tree_leaves(val))
    if _is_dims(dims):
        return [tuple(entry[x] for x in dims)]
    return [s for v, d in zip(val, dims) for s in _dims_specs(v, d, entry)]


def over_batch_heads(ins: tuple, outs, key: int = 0):
    """Decorator: on DTensors the primitive runs once a shard (`per_shard`,
    through `when_placed`), each rank its own batch rows and heads over the
    whole of every other dim. `ins` declares each parameter's dims in order
    and `outs` the result's, as `_dims_specs` reads them; argument `key`'s
    batch and heads splits (`batch_heads`) hold for all."""
    def sharded(fn, *args, **kwargs):
        bound = inspect.signature(fn).bind(*args, **kwargs)
        bound.apply_defaults()
        vals = tuple(bound.arguments.values())
        bs, hs = batch_heads(args[key], ins[key].index("heads"))
        entry = {"batch": bs, "heads": hs, None: None}
        specs = [s for v, d in zip(vals, ins) for s in _dims_specs(v, d, entry)]
        out_specs = [tuple(entry[x] for x in d)
                     for d in pytree.tree_leaves(outs, is_leaf=_is_dims)]
        return per_shard(fn, vals, tuple(specs), tuple(out_specs))
    return when_placed(sharded, key)


def bshard(x: torch.Tensor) -> torch.Tensor:
    """Constrain block-boundary activations: batch over the data axes and,
    for (B, S, D) activations, seq over `model` (sequence parallelism).
    Indivisible dims fall back to replicated."""
    if x.ndim >= 3:
        return constrain(x, ("batch", "seq_act") + (None,) * (x.ndim - 2))
    return constrain(x, ("batch",) + (None,) * (x.ndim - 1))


def logical_spec(shape, logical: Tuple[Optional[str], ...],
                 rules: Dict[str, Tuple[str, ...]]) -> tuple:
    """The spec of an activation of `shape` whose dims carry `logical`
    names under `rules` (no mesh filter; sizes from `__sizes__`)."""
    sizes = rules.get("__sizes__") or None
    return tuple(_spec_entry(axes_for_dim(name, shape[i], rules, mesh_names=None,
                                          mesh_sizes=sizes))
                 for i, name in enumerate(logical))


def constrain(x: torch.Tensor, logical: Tuple[Optional[str], ...]) -> torch.Tensor:
    """Place `x` by its logical axes if a context is active (else the
    identity). Only a DTensor moves; axes that do not divide their dim are
    dropped (`partitioning.axes_for_dim`)."""
    rules = _RULES.get()
    if rules is None or not isinstance(x, DTensor):
        return x
    placements = to_placements(logical_spec(x.shape, logical, rules), x.device_mesh, x.shape)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


# -- placement helpers: DTensors move, plain tensors pass through ------------------


def split_ranks(t: torch.Tensor, dim: int) -> int:
    """How many ranks split dimension `dim` of `t` (1 for a plain tensor)."""
    if not isinstance(t, DTensor):
        return 1
    dim = dim % t.ndim
    return int(np.prod([size for size, p in zip(t.device_mesh.mesh.shape, t.placements)
                        if p.is_shard(dim)]))


def gather_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` with dimension `dim` whole on every rank: a DTensor split along
    it is all-gathered over the mesh axes that split it (XLA's FSDP gather
    of a weight's `embed` dim before its matmul). A plain tensor as it is."""
    dim = dim % t.ndim
    if not isinstance(t, DTensor) or not any(p.is_shard(dim) for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_shard(dim) else p
                                          for p in t.placements])


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """A (B, S, ...) activation with its sequence whole on every rank: the
    gather before a projection that sequence parallelism implies (XLA's
    SPMD partitioner inserts it; DTensor's planner, left to find it for a
    sequence split beside a batch split over two axes, takes minutes)."""
    return gather_dim(x, 1) if x.ndim >= 3 else x


class _SeqWholeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return gather_seq(g)


def seq_whole_grad(y: torch.Tensor) -> torch.Tensor:
    """`y`, whose gradient is gathered over the sequence before it flows
    back into the projection that made `y`: the mirror of `gather_seq` for
    a projection's output added onto a sequence-split residual stream
    (the backward's all-gather of sequence parallelism). A plain tensor as
    it is."""
    return _SeqWholeGrad.apply(y) if isinstance(y, DTensor) else y


def _pad_seq_sharded(fn, t, before: int, after: int):
    from torch.distributed.tensor.experimental import local_map
    t = gather_dim(t, 1)
    pl = list(t.placements)
    return local_map(lambda tl: fn(tl, before, after), out_placements=pl, in_placements=(pl,),
                     device_mesh=t.device_mesh)(t)


@when_placed(_pad_seq_sharded)
def pad_seq(t: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """`t` zero-padded along dim 1 (`before` rows in front, `after`
    behind), as `F.pad` does. A DTensor is padded once a shard, its dim 1
    whole first: torch 2.11's DTensor `pad` gives its output a placement
    of the wrong length on a 2-D mesh."""
    return F.pad(t, (0, 0) * (t.ndim - 2) + (before, after))
