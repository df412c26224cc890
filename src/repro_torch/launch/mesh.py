"""Client meshes on ``torch.distributed`` (``repro.launch.mesh``'s client
and feature meshes).

The reference is single-controller: one process holds the whole (I, ...)
client stack and ``shard_map`` splits it over a ``jax.sharding.Mesh``. The
port runs one process a rank (SPMD): every rank runs the same driver on the
same inputs, and a mesh here is a 1-D ``torch.distributed.device_mesh.
DeviceMesh`` whose one axis carries the clients ("data" for the
sample-based clients, "model" for the feature clients), as in the
reference.

The device picks the backend: NCCL on a CUDA device (with
``torch.cuda.set_device(LOCAL_RANK)``), gloo on the CPU. A group the caller
has already started is taken as it is, whatever its backend. Run alone (no
``torchrun`` environment) the helpers start a one-rank group themselves
(an in-process ``HashStore``: no file, no port), which still runs every
collective: the reference's 1-device mesh still runs its shard_map + psum
path. Under ``torchrun --nproc-per-node D`` the mesh spans the D ranks. A
failed NCCL start raises; gloo never stands in for it.

Functions only: importing this module touches no process group.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch import device as device_lib


def backend_for(device) -> str:
    """NCCL on a CUDA device, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_group(device=None) -> torch.device:
    """Start this process's default group unless one is running: under
    ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the master's
    address in the environment) over its ranks, else a one-rank group.
    Returns the device this rank computes on (``cuda:LOCAL_RANK`` on a
    card; ``device=None`` is the card, as everywhere in the port)."""
    dev = device_lib.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(dev)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev


def make_client_mesh(num_devices: int | None = None, axis: str = "data",
                     device=None):
    """1-D client mesh over every rank of the group (started by
    ``init_group`` when none runs): ``axis`` carries the paper's clients,
    rank r holds the r-th contiguous block of them. ``num_devices``, when
    given, must be the group's size: a rank left out of the mesh would hold
    no clients."""
    dev = init_group(device)
    world = dist.get_world_size()
    n = world if num_devices is None else num_devices
    if n != world:
        raise RuntimeError(
            f"need {n} ranks for the client mesh, the group has {world}; "
            f"run under torchrun --nproc-per-node {n}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, (n,), mesh_dim_names=(axis,))


def make_feature_mesh(num_devices: int | None = None, device=None):
    """1-D "model"-axis mesh for the sharded feature-based topology: each
    rank holds a contiguous block of the vertical-FL feature clients.
    Same rank policy as :func:`make_client_mesh`."""
    return make_client_mesh(num_devices, axis="model", device=device)
