"""End-to-end training entry point. Mirror of ``repro.launch.train``.

Wires every substrate together: the model zoo + AdamW + the synthetic data
pipeline + the I/O-aware runtime for async checkpointing (auto-constrained
shard writes overlapping train steps), resume-from-latest, SIGTERM
preemption save, and the baseline mode (--no-io-aware: synchronous
checkpoints and batches read in line, the paper's non-I/O-aware baseline).
Its checkpoints are the JAX package's format: either package resumes the
other's.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 4 \
      --batch 4 --seq 1024 --ckpt-dir build/ck --ckpt-every 4
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import ARCHS, get_config, get_smoke_config
from ..configs.base import ModelConfig
from ..core import Cluster, IORuntime, RealBackend, StorageDevice, WorkerNode
from ..data import PrefetchLoader, SyntheticCorpus
from ..device import resolve_device
from ..models import Model
from ..optim import AdamWConfig, adamw_init, adamw_update

PRESETS = {
    # ~100M-class model for real-hardware runs; smaller ones for CPU demos
    "100m": ModelConfig(name="repro-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
                        vocab_size=32000, remat=False),
    "20m": ModelConfig(name="repro-20m", family="dense", n_layers=6,
                       d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
                       vocab_size=8192, remat=False),
    "5m": ModelConfig(name="repro-5m", family="dense", n_layers=4,
                      d_model=256, n_heads=4, n_kv_heads=4, d_ff=768,
                      vocab_size=4096, remat=False),
}


def build_cluster(io_executors: int = 8, device_bw: float = 2000.0):
    """One 'host' with a checkpoint filesystem device. The bandwidth number
    is the budget the scheduler constrains against (MB/s)."""
    dev = StorageDevice(name="ckpt-fs", bandwidth=device_bw,
                        per_stream_cap=device_bw / 4)
    return Cluster(workers=[WorkerNode(name="host0", cpus=4,
                                       io_executors=io_executors,
                                       storage=dev)])


def train_step(model: Model, params, opt_state, batch: dict, opt: AdamWConfig):
    """One step on the numpy ``batch``, which goes to the parameters' device
    here: the loss, its gradients by backward, AdamW on ``.grad``. Updates
    ``params`` (the model) and ``opt_state``'s moments in place; returns
    (new opt_state, loss, gnorm) as 0-d device tensors."""
    device = next(params.parameters()).device
    b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    loss = model.loss(params, b)
    loss.backward()
    named = dict(params.named_parameters())
    _, opt_state, gnorm = adamw_update({k: p.grad for k, p in named.items()}, named,
                                       opt_state, opt)
    for p in named.values():
        p.grad = None
    return opt_state, loss.detach(), gnorm


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          ckpt_dir: str | None, ckpt_every: int, io_aware: bool = True,
          resume: bool = True, log_path: str | None = None,
          opt: AdamWConfig | None = None, seed: int = 0, device=None):
    """``device``: default the current CUDA device. Returns the reference's
    keys; ``params`` is the model (a ``Transformer``, an ``SSM`` for mamba2,
    a ``Zamba2`` for zamba2), ``opt_state`` its AdamW state. For the SSM and
    hybrid families ``seq`` must be a multiple of ``cfg.ssm_chunk``."""
    device = resolve_device(device)
    model = Model(cfg)
    opt = opt or AdamWConfig(total_steps=max(steps, 2), warmup_steps=max(steps // 10, 1))
    params = model.init(seed, device=device)
    opt_state = adamw_init(params.state_dict())
    corpus = SyntheticCorpus(cfg.vocab_size, seq, batch, seed=seed)

    mgr = CheckpointManager(ckpt_dir, n_shards=8) if ckpt_dir else None
    start_step = 0
    if mgr and resume and mgr.latest_step() is not None:
        (weights, opt_state), start_step = mgr.restore((params.state_dict(), opt_state))
        params.load_state_dict(weights)
        del weights
        start_step += 1
        print(f"[train] resumed from step {start_step - 1}", flush=True)

    stop = {"now": False}

    def _sigterm(signum, frame):
        stop["now"] = True  # preemption: finish step, sync-save, exit
    old = signal.signal(signal.SIGTERM, _sigterm)

    log_f = open(log_path, "a") if log_path else None
    cluster = build_cluster()
    losses = []
    t_start = time.monotonic()
    try:
        with IORuntime(cluster, backend=RealBackend()) as rt:
            loader = PrefetchLoader(corpus, depth=2) if io_aware else None
            for step in range(start_step, steps):
                b = loader.get(step) if io_aware else corpus.batch(step)
                opt_state, loss, gnorm = train_step(model, params, opt_state, b, opt)
                losses.append(float(loss))
                if log_f:
                    log_f.write(json.dumps({"step": step, "loss": losses[-1],
                                            "gnorm": float(gnorm),
                                            "t": time.monotonic() - t_start}) + "\n")
                    log_f.flush()
                if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
                    mgr.save(step, (params.state_dict(), opt_state), sync=not io_aware)
                if stop["now"]:
                    print(f"[train] SIGTERM at step {step}: final sync save",
                          flush=True)
                    if mgr:
                        mgr.save(step, (params.state_dict(), opt_state), sync=True)
                    break
            if mgr:
                mgr.wait()
            stats = rt.stats()
    finally:
        signal.signal(signal.SIGTERM, old)
        if log_f:
            log_f.close()
    return {"losses": losses, "steps_run": len(losses),
            "final_loss": losses[-1] if losses else None,
            "runtime_stats": {k: v for k, v in stats.items()
                              if k not in ("tuners",)},
            "wall_s": time.monotonic() - t_start,
            "params": params, "opt_state": opt_state}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default=None)
    ap.add_argument("--preset", choices=list(PRESETS), default="20m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--no-io-aware", action="store_true")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device")
    args = ap.parse_args(argv)

    if args.arch:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    else:
        cfg = PRESETS[args.preset]
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                io_aware=not args.no_io_aware, resume=not args.no_resume,
                log_path=args.log, device=args.device)
    print(f"[train] {out['steps_run']} steps, final loss "
          f"{out['final_loss']:.4f}, wall {out['wall_s']:.1f}s")
    first, last = out["losses"][0], out["final_loss"]
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
