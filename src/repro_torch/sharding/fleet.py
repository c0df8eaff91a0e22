"""Fleet-service sharding: the `clients`×`slabs` serving mesh of the cloud
LoD sync path. Port of `repro.sharding.fleet` onto `torch.distributed`.

The reference runs one controller under GSPMD: `NamedSharding` constraints
on global arrays, the partitioner inserting the collectives. PyTorch has no
counterpart, and DTensor's propagation covers neither `nonzero`, index
scatters nor the kernels' ctypes entry points, all of which the sync path
runs. So the port is SPMD over processes:

  * one process a rank; rank r is mesh coordinate (r // slabs, r % slabs),
    the reference's row-major device order. Every rank runs the same host
    control plane (admission, slot maps, the rate controller, the
    scheduler's selection, the journal) from the same inputs;
  * state is plain local tensors, one block a rank. Client shard i holds
    slots [i·C/k, (i+1)·C/k) of every per-slot leaf (`ServiceState`,
    `ServiceStats`, the Δ payload's per-slot rows, fallback frames); the
    shared slab tables are blocked on Ns over `slabs`; the encode-once
    union's rows split over `slabs` for the codec. An axis whose size does
    not divide the dimension replicates (`partitioning.axes_for_dim`), so a
    1×1 mesh, or an indivisible capacity, is bitwise the meshless service;
  * each cross-shard step is an explicit collective on the axis's process
    group (`all_gather_blocks`, `all_reduce`), and each leaf keeps a
    placement record: the reference's `PartitionSpec` as a tuple
    (`fleet_shardings`, `slab_shardings`).

Collectives on integers and selects are exact, so the meshed service gives
the meshless one's bits; `fleet_totals`' float columns reassociate their
sums across shards (within rtol 1e-6, as in the reference).

Gloo moves CUDA tensors through host memory (it stages them itself); NCCL
keeps them on the card. Either way every rank computes on its own device:
the staging is transport, never a fallback.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.sharding.partitioning import logical_to_pspec

# logical → mesh axes for the serving stack (remappable: a launcher that
# wants clients over another axis passes its own rules)
FLEET_RULES: Dict[str, Tuple[str, ...]] = {
    "clients": ("clients",),   # leading slot axis of per-client state
    "slabs": ("slabs",),       # Ns axis of the shared slab tables
    "union": ("slabs",),       # row axis of the encode-once codec work
}
AXES = ("clients", "slabs")


class FleetMesh:
    """The serving mesh over an initialised process group of
    clients·slabs ranks (`repro_torch.launch.mesh.make_fleet_mesh` builds
    one): `device_mesh` is the `torch.distributed.DeviceMesh` whose named
    dims give each axis's group."""

    axis_names = AXES

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.sizes = tuple(int(n) for n in device_mesh.mesh.shape)
        self.rank = dist.get_rank()
        self.coords = (self.rank // self.sizes[1], self.rank % self.sizes[1])
        self._groups = {a: device_mesh.get_group(a) for a in AXES}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.sizes))

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        return self._groups[axis]


def fleet_axis_rules(mesh, rules: Optional[Dict[str, Tuple[str, ...]]] = None
                     ) -> Dict[str, Tuple[str, ...]]:
    """`FLEET_RULES` filtered to `mesh`'s axes, with `__sizes__` attached."""
    base = dict(FLEET_RULES if rules is None else rules)
    names = set(mesh.axis_names)
    out = {k: tuple(a for a in v if a in names)
           for k, v in base.items() if k != "__sizes__"}
    out["__sizes__"] = dict(mesh.shape)
    return out


# -- ambient mesh -----------------------------------------------------------

_FLEET_MESH: contextvars.ContextVar[Optional[FleetMesh]] = (
    contextvars.ContextVar("fleet_mesh", default=None))


def current_fleet_mesh() -> Optional[FleetMesh]:
    return _FLEET_MESH.get()


@contextlib.contextmanager
def use_fleet_mesh(mesh: Optional[FleetMesh]):
    """Install `mesh` as the ambient serving mesh: a `LodService` built
    inside takes it when it is given none."""
    token = _FLEET_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _FLEET_MESH.reset(token)


def resolve_mesh(mesh: Optional[FleetMesh]) -> Optional[FleetMesh]:
    """Explicit mesh if given, else the ambient one (else None)."""
    return mesh if mesh is not None else _FLEET_MESH.get()


def mesh_signature(mesh) -> Optional[List[list]]:
    """JSON-able identity of a serving mesh, [[axis, size], ...] in axis
    order (the reference's form), or None for the meshless service. Recorded
    in snapshot manifests."""
    if mesh is None:
        return None
    return [[str(a), int(mesh.shape[a])] for a in mesh.axis_names]


def _axis_shards(mesh, axis: str, length: int) -> int:
    if mesh is None or axis not in mesh.axis_names:
        return 1
    k = int(mesh.shape[axis])
    return k if k > 0 and length % k == 0 else 1


def client_shards(mesh, capacity: int) -> int:
    """How many client shards the slot axis splits into: the mesh's
    `clients` size when it divides `capacity`, else 1 (replicated)."""
    return _axis_shards(mesh, "clients", capacity)


def slab_shards(mesh, n: int) -> int:
    """How many blocks an axis of length `n` on `slabs` splits into (the
    slab tables' Ns, the union's rows): the `slabs` size when it divides,
    else 1."""
    return _axis_shards(mesh, "slabs", n)


def block(mesh, axis: str, n_blocks: int, length: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's block of an axis of `length` split into
    `n_blocks` over `axis` (the whole axis when n_blocks is 1)."""
    if n_blocks <= 1:
        return 0, length
    step = length // n_blocks
    i = mesh.index(axis)
    return i * step, (i + 1) * step


# -- placement records --------------------------------------------------------


def fleet_pspec(mesh, logical: Tuple[Optional[str], ...], shape: Tuple[int, ...]):
    """Spec of one leaf under the fleet rules (indivisible dims replicate)."""
    return logical_to_pspec(logical, mesh, tuple(shape), fleet_axis_rules(mesh))


def _leading_axis_specs(mesh, tree: Any, axis_name: str):
    def one(leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return ()
        return fleet_pspec(mesh, (axis_name,) + (None,) * (len(shape) - 1), shape)
    return pytree.tree_map(one, tree)


def fleet_shardings(mesh, state: Any):
    """The placement record of a per-client tree: the spec of each leaf
    (its global shape: a tensor, or one on the `meta` device), leading with
    the slot axis. Scalars replicate; an indivisible slot axis replicates."""
    return _leading_axis_specs(mesh, state, "clients")


def slab_shardings(mesh, tables: Any):
    """The placement record of the shared slab tables (`SlabTables`: every
    leaf leads with Ns)."""
    return _leading_axis_specs(mesh, tables, "slabs")


def global_shapes(tree: Any, n_blocks: int):
    """`tree`'s leaves as `meta` tensors of their global shape, where each
    leaf of one or more dims is one of `n_blocks` blocks of its leading
    axis."""
    def one(x):
        if x.dim() == 0:
            return torch.empty((), dtype=x.dtype, device="meta")
        return torch.empty((x.shape[0] * n_blocks,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device="meta")
    return pytree.tree_map(one, tree)


def shard_participation(mesh, mask) -> np.ndarray:
    """This rank's bits of a per-tick (C,) participation mask: each client
    shard takes its own slots' bits, as every other per-slot leaf, so the
    partial-sync masking stays shard-local. The whole mask without a mesh
    (or on an indivisible slot axis)."""
    mask = np.asarray(mask, bool)
    lo, hi = block(mesh, "clients", client_shards(mesh, mask.shape[0]), mask.shape[0])
    return mask[lo:hi]


def _slice_leading(tree: Any, lo: int, hi: int, clone: bool = True):
    # a clone, so the rank keeps its block and not the whole array
    return pytree.tree_map(
        lambda x: x if x.dim() == 0 else (x[lo:hi].clone() if clone else x[lo:hi]), tree)


def _leading_length(tree: Any) -> int:
    for x in pytree.leaves(tree):
        if x.dim() >= 1:
            return int(x.shape[0])
    return 0


def shard_service_state(mesh, state: Any):
    """This rank's block of a whole per-client tree (every leaf of one or
    more dims leads with the slot axis): the slots of its client shard, or
    everything where the mesh does not divide the capacity."""
    cap = _leading_length(state)
    if mesh is None or cap == 0:
        return state
    lo, hi = block(mesh, "clients", client_shards(mesh, cap), cap)
    return state if (lo, hi) == (0, cap) else _slice_leading(state, lo, hi)


def shard_slab_tables(mesh, tables: Any):
    """This rank's block of the whole slab tables, on the `slabs` axis: views,
    as the whole tables are views of the tree every rank holds (the block
    adds no bytes and saves none)."""
    if mesh is None:
        return tables
    ns = _leading_length(tables)
    lo, hi = block(mesh, "slabs", slab_shards(mesh, ns), ns)
    return tables if (lo, hi) == (0, ns) else _slice_leading(tables, lo, hi, clone=False)


# -- collectives ----------------------------------------------------------------


def all_gather_blocks(mesh, axis: str, tensors: Sequence[torch.Tensor]
                      ) -> List[torch.Tensor]:
    """All-gather equally shaped tensors over `axis`: for each input, an
    (n, *shape) stack of every rank's copy in axis order. The bytes of all
    inputs travel in one collective (any dtype; bitwise)."""
    n = mesh.size(axis)
    flats = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    sizes = [f.numel() for f in flats]
    buf = torch.cat(flats) if flats else torch.empty((0,), dtype=torch.uint8)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=mesh.group(axis))
    stacked = torch.stack(parts)
    out, off = [], 0
    for t, size in zip(tensors, sizes):
        chunk = stacked[:, off:off + size].contiguous()
        out.append(chunk.view(t.dtype).reshape((n,) + tuple(t.shape)))
        off += size
    return out


def all_reduce(mesh, axis: str, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of `t` over `axis` (bool inputs reduce as uint8)."""
    dtype = t.dtype
    x = t.detach().to(torch.uint8 if dtype == torch.bool else dtype).clone()
    dist.all_reduce(x, op=op, group=mesh.group(axis))
    return x.to(torch.bool) if dtype == torch.bool else x


def count_dtype(n: int) -> torch.dtype:
    """The narrowest integer type a cross-shard count up to `n` travels
    in."""
    return torch.uint8 if n < 256 else (torch.int16 if n < 32768 else torch.int32)


def broadcast_object(obj, src: int = 0):
    """`obj` as rank `src` holds it, on every rank of the world (the control
    plane's choices that a rank's clock could otherwise make differently,
    such as a scheduler tick's selection)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def replicate_fleet(mesh, tree: Any, n_shards: int, axis: str = "clients"):
    """The whole tree on every rank from the rank blocks of `tree` (each
    leaf of one or more dims one of `n_shards` blocks of its leading axis
    over `axis`): an all-gather. The identity for one block."""
    if mesh is None or n_shards <= 1:
        return tree
    leaves = [x for x in pytree.leaves(tree) if x.dim() >= 1]
    gathered = iter(all_gather_blocks(mesh, axis, leaves))
    return pytree.tree_map(
        lambda x: x if x.dim() == 0 else next(gathered).reshape(
            (-1,) + tuple(x.shape[1:])), tree)


def gather_row(mesh, x: torch.Tensor, slot: int, n_shards: int) -> torch.Tensor:
    """Row `slot` (a global slot index) of a per-slot leaf held as blocks
    over `clients`, broadcast from its owner to every rank of the axis."""
    if mesh is None or n_shards <= 1:
        return x[slot]
    per = x.shape[0]
    owner, local = divmod(int(slot), per)
    row = x[local].contiguous() if owner == mesh.index("clients") else torch.empty_like(x[0])
    return all_gather_blocks(mesh, "clients", [row])[0][owner]


# -- cross-shard reductions ---------------------------------------------------


def fleet_totals(stats: Any, mesh=None, capacity: Optional[int] = None):
    """Reduce per-slot stats columns ((C,) leaves) to fleet totals: a local
    sum, then an all-reduce over `clients` when the leaves are client
    blocks. `capacity` is the fleet's (global) slot count, which says
    whether they are; without it the leaves are taken as the whole fleet.
    Bool columns count (int32). Integer totals are exact either way; float
    columns may differ in the last bits (per-shard partial sums)."""
    mesh = resolve_mesh(mesh)

    def local(a):
        # in the column's own type, as the reference sums (torch would widen
        # integers to int64)
        x = a.to(torch.int32) if a.dtype == torch.bool else a
        return x.sum(0, dtype=x.dtype)

    totals = pytree.tree_map(local, stats)
    if capacity is None or client_shards(mesh, int(capacity)) <= 1:
        return totals
    return pytree.tree_map(lambda a: all_reduce(mesh, "clients", a), totals)


def shard_resident_bytes(mesh, *trees: Any) -> int:
    """This rank's resident bytes of the given trees as it holds them (its
    blocks; with no mesh, the whole trees): the bytes of each storage under
    their leaves, once however many leaves view it (the slab tables are
    views of the tree's arrays)."""
    del mesh  # the trees are the rank's own blocks already
    storages = {}
    for t in trees:
        for x in pytree.leaves(t):
            if x.device.type != "meta":
                st = x.untyped_storage()
                storages[(x.device, st.data_ptr())] = st.nbytes()
    return int(sum(storages.values()))
