"""Burst-buffer checkpointing on the real backend, on the port
(``repro_torch.checkpoint``, ``repro_torch.core``).

A tiny train loop snapshots its state (tensors on the device) every few
steps. With ``CheckpointManager(fast_dir=...)`` each shard is written
(fsync'd) to the fast tier first — absorbing the write burst at
SSD/burst-buffer speed — then drained to the durable shared directory by
background drain I/O tasks; the manifest commits on the shared side only
after every shard landed, so restarts never observe a half-drained
checkpoint. ``RealBackend(tier_dirs=)`` gives the runtime the tier→directory
mapping used by ``rt.drain`` / ``rt.prefetch`` for ad-hoc file movement.

Capacity-aware GC: the burst buffer is finite, so the manager trims it more
aggressively than the durable copy — ``fast_keep`` (default
``min(keep, 1)``) bounds how many steps' shards linger on the fast tier,
while ``keep`` durable checkpoints survive on the shared FS. The run prints
both directory listings at the end: the fast tier holds only the newest
step, the shared FS the full retention window.

Run:  PYTHONPATH=src python examples/torch/burst_buffer_checkpoint.py [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import (Cluster, IORuntime, RealBackend, StorageDevice,
                              WorkerNode, task)
from repro_torch.device import resolve_device


@task(returns=1)
def train_step(state, i):
    return {k: v + 0.1 for k, v in state.items()}


def main(device):
    root = Path(tempfile.mkdtemp(prefix="bb_ckpt_"))
    bb_dir, fs_dir = root / "burst_buffer", root / "shared_fs"

    ssd = StorageDevice(name="local-ssd", bandwidth=2000, per_stream_cap=500,
                        capacity_gb=0.01)  # a deliberately tiny burst buffer
    fs = StorageDevice(name="pfs", bandwidth=400, per_stream_cap=80,
                       tier="fs")
    cluster = Cluster(workers=[WorkerNode(name="w0", cpus=4, io_executors=8,
                                          tiers=[ssd, fs])])
    # keep 3 durable checkpoints on the shared FS but only the newest step's
    # shards on the finite fast tier (fast_keep defaults to min(keep, 1))
    mgr = CheckpointManager(fs_dir, n_shards=4, fast_dir=bb_dir, drain_bw=80,
                            overrun_policy="wait", keep=3)

    gen = torch.Generator(device=device).manual_seed(0)
    state = {"w": torch.randn((256, 256), generator=gen, dtype=torch.float64, device=device),
             "b": torch.zeros(256, dtype=torch.float64, device=device)}
    backend = RealBackend(tier_dirs={"ssd": bb_dir, "fs": fs_dir})
    with IORuntime(cluster, backend=backend) as rt:
        fut = None
        for i in range(6):
            fut = train_step(state if fut is None else fut, i)
            if (i + 1) % 2 == 0:
                snap = rt.wait_on(fut)
                mgr.save(i + 1, snap)
                print(f"step {i + 1}: checkpoint dispatched "
                      f"(fast tier: {bb_dir.name})")
        mgr.wait()

    restored, step = mgr.restore(state)
    print(f"restored step {step}: w mean {float(restored['w'].mean()):+.4f}")
    drained = sorted(p.name for p in
                     (fs_dir / f"step_{step:08d}").glob("shard_*.bin"))
    print(f"durable shards on shared FS: {drained}")
    durable_steps = sorted(d.name for d in fs_dir.glob("step_*"))
    fast_steps = sorted(d.name for d in bb_dir.glob("step_*"))
    print(f"durable checkpoints (keep={mgr.keep}): {durable_steps}")
    print(f"fast-tier residue (fast_keep={mgr.fast_keep}): {fast_steps}")
    assert len(fast_steps) <= mgr.fast_keep  # mgr.wait() trimmed the rest


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    main(resolve_device(ap.parse_args().device))
