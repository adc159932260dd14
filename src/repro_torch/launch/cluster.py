"""Multi-host process wiring (real-cluster path). Mirror of
``repro.launch.cluster``.

Every host runs the same entrypoint; ``initialize_cluster()`` wires
``torch.distributed`` from the environment (COORDINATOR_ADDR, as
``host:port``, NUM_PROCESSES and PROCESS_ID, as launch scripts set them),
and ``global_runtime_cluster()`` builds the I/O-aware runtime's resource
view of the fleet: one worker entry per host, all referencing the shared
checkpoint filesystem device so the paper's bandwidth constraints are
accounted fleet-wide.

Failure/elasticity protocol: the launcher relaunches survivors with a
smaller NUM_PROCESSES after a node failure; checkpoints store whole logical
leaves, so ``CheckpointManager.restore(..., shardings=new_mesh_shardings)``
re-shards onto whatever mesh the relaunch built.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..core import Cluster, StorageDevice, WorkerNode
from ..device import resolve_device


def initialize_cluster(device=None) -> dict:
    """Idempotent ``init_process_group`` from the environment (NCCL on CUDA,
    gloo on the CPU). Returns topology info. A no-op for one process."""
    coord = os.environ.get("COORDINATOR_ADDR")
    nproc = int(os.environ.get("NUM_PROCESSES", "1"))
    pid = int(os.environ.get("PROCESS_ID", "0"))
    if nproc > 1 and not dist.is_initialized():
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://{coord}", world_size=nproc, rank=pid)
    count = dist.get_world_size() if dist.is_initialized() else 1
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {"process_index": dist.get_rank() if dist.is_initialized() else 0,
            "process_count": count,
            "local_devices": local,
            "global_devices": local * count}


def global_runtime_cluster(ckpt_bw_mbs: float = 2000.0,
                           io_executors_per_host: int = 8) -> Cluster:
    """The I/O-aware runtime's fleet view: hosts share one checkpoint-FS
    device, so storage-bandwidth constraints bound CONCURRENT WRITERS
    FLEET-WIDE. Per-host runtimes schedule only their own shards; the budget
    each host may assume is its fair slice (coordinator-free, conservative)."""
    n = max(dist.get_world_size() if dist.is_initialized() else 1, 1)
    index = dist.get_rank() if dist.is_initialized() else 0
    shared = StorageDevice(name="ckpt-fs", bandwidth=ckpt_bw_mbs / n,
                           per_stream_cap=ckpt_bw_mbs / n / 4)
    me = WorkerNode(name=f"host{index}", cpus=4,
                    io_executors=io_executors_per_host, storage=shared)
    return Cluster(workers=[me])
