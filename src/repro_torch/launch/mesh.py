"""The cloud-serving mesh on `torch.distributed`. Port of
`repro.launch.mesh.make_fleet_mesh` (the production LM meshes go with the
LM families).

`make_fleet_mesh(clients, slabs)` needs an initialised process group of
clients·slabs ranks, as the reference needs that many devices:
`init_fleet_group` starts one from a `file://` store (no TCP port), one
process a rank. Gloo serves CPU ranks and several ranks sharing one card
(NCCL refuses two ranks on one device); NCCL serves one rank a card.
"""

from __future__ import annotations

import os

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

