"""Production and host meshes (the JAX package's ``launch/mesh.py``).

Functions, not module-level constants: importing this module starts no
process group and touches no device.  Both meshes have the reference's
axis names.
"""
from __future__ import annotations

import socket

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import device as _device


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``, over the default process group, which must exist and hold
    256 or 512 ranks (the dry-run's fake group does)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        world = dist.get_world_size() if dist.is_initialized() else None
        raise RuntimeError(f"the production mesh {shape} needs a process "
                           f"group of {n} ranks; the default group has "
                           f"{world}")
    return init_device_mesh(_device.resolve(device).type, shape,
                            mesh_dim_names=axes)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_host_mesh(device="cuda") -> DeviceMesh:
    """The (1, 1) ``("data", "model")`` mesh over a world of one: NCCL on
    the card, gloo on the CPU.  Starts the default group (rank 0 of 1, on
    ``tcp://localhost`` at a free port) unless one of size 1 exists; the
    caller destroys it (``dist.destroy_process_group()``)."""
    dev = _device.resolve(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend,
                                init_method=f"tcp://localhost:{_free_port()}",
                                world_size=1, rank=0)
    if dist.get_world_size() != 1:
        raise RuntimeError(f"the host mesh needs a world of one, the default "
                           f"group has {dist.get_world_size()} ranks")
    if dist.get_backend() != backend:
        raise RuntimeError(f"the host mesh on {dev.type} needs {backend}, "
                           f"the default group is {dist.get_backend()}")
    return init_device_mesh(dev.type, (1, 1),
                            mesh_dim_names=("data", "model"))
