"""Meshes on `torch.distributed`: the production LM meshes and the
cloud-serving mesh. Port of `repro.launch.mesh`.

`make_production_mesh` and `make_mesh` build a named `DeviceMesh` over the
default process group, whose world must hold as many ranks as the mesh
has devices: (16, 16) ("data", "model") is one pod, (2, 16, 16) ("pod",
"data", "model") two, the reference's shapes, so that the specs equal
JAX's cell for cell. Axis semantics: `pod` is data parallel across pods,
`data` FSDP and data parallel within a pod, `model` tensor and expert
parallel. The dry-run builds them in a fake world (`init_fake_world`): a
process group of N ranks that carries no data, over which DTensors of
meta tensors trace a step with every collective it would issue.

`make_fleet_mesh(clients, slabs)` needs an initialised process group of
clients·slabs ranks, as the reference needs that many devices:
`init_fleet_group` starts one from a `file://` store (no TCP port), one
process a rank. Gloo serves CPU ranks and several ranks sharing one card
(NCCL refuses two ranks on one device); NCCL serves one rank a card.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sharding.fleet import AXES, FleetMesh


def _indexed(device: DeviceLike) -> torch.device:
    """The device, with the current card's index where a CUDA device names
    none (NCCL and `set_device` need one)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def init_fleet_group(store_path: str, rank: int, world_size: int,
                     backend: str = "gloo", device: DeviceLike = None) -> None:
    """Initialise the default process group of this rank from a `file://`
    store at `store_path` (a file no rank has used yet). `device` is the
    rank's compute device (the card when None): NCCL binds to it."""
    kw = {}
    if backend == "nccl":
        kw["device_id"] = _indexed(device)
    dist.init_process_group(backend, init_method="file://" + os.path.abspath(store_path),
                            rank=int(rank), world_size=int(world_size), **kw)


def init_fake_world(world_size: int) -> None:
    """Start a fake default process group of `world_size` ranks, this
    process rank 0: collectives return at once and move nothing (the
    dry-run's stand-in for the reference's placeholder devices)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=int(world_size))


def make_mesh(shape, axes, device: DeviceLike = "cpu"):
    """A `DeviceMesh` of `shape` with dims named `axes` over the default
    process group (a fake world, or one rank a card). `device` is where
    the ranks compute: the CPU for a fake world (its tensors are meta),
    the card for NCCL."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs an initialised process group "
                           "(init_fake_world, or init_fleet_group)")
    n = int(np.prod(shape))
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks, the process group has "
                           f"{dist.get_world_size()}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(_indexed(dev))
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = "cpu"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_fleet_mesh(clients: int = 1, slabs: int = 1,
                    device: DeviceLike = None) -> FleetMesh:
    """The clients×slabs serving mesh over the default process group, whose
    world must hold clients·slabs ranks (rank r is coordinate (r // slabs,
    r % slabs)). Every rank calls it, in the same order as its other
    collectives. `device` is where this rank computes (the card when
    None): the DeviceMesh's device type."""
    from torch.distributed.device_mesh import init_device_mesh

    clients, slabs = int(clients), int(slabs)
    if clients < 1 or slabs < 1:
        raise ValueError(f"mesh axes must be >= 1, got clients={clients} slabs={slabs}")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"a {clients}x{slabs} fleet mesh needs an initialised process "
                           "group of that many ranks (init_fleet_group)")
    world = dist.get_world_size()
    if world != clients * slabs:
        raise RuntimeError(f"a {clients}x{slabs} fleet mesh needs {clients * slabs} ranks, "
                           f"the process group has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(_indexed(dev))
    return FleetMesh(init_device_mesh(dev.type, (clients, slabs), mesh_dim_names=AXES))


def destroy_fleet_group() -> None:
    """Tear down the default process group, if any."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()

