"""Production mesh builders. Mirror of ``repro.launch.mesh``.

Each builds a ``torch.distributed`` ``DeviceMesh`` with the reference's axis
names over the ranks of the process group. Defined as functions, so
importing this module starts nothing.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..device import resolve_device


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 single pod (256 ranks) or 2x16x16 two-pod (512 ranks), over an
    initialised process group of exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"make_production_mesh: a {'x'.join(map(str, shape))} mesh needs "
                         f"{need} ranks, the process group has {world}")
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=axes)


def make_local_mesh(device=None):
    """A ``(world, 1)`` mesh over ``("data", "model")`` on the caller's
    device type (CUDA unless ``device='cpu'``). In a single process with no
    process group it first starts a world-1 group of its own on a free
    local port: NCCL for CUDA, gloo for the CPU."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                              timeout=datetime.timedelta(seconds=60))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=store,
                                rank=0, world_size=1)
    return init_device_mesh(dev.type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))
