"""Where the time of the port's train path goes, and how much of a
checkpoint the I/O-aware runtime hides, on one GPU.

  python3 scripts/profile_train_torch.py [--arch tinyllama-1.1b|mamba2-2.7b|zamba2-1.2b]
      [--steps 3] [--strategy tp_fsdp] [--overlap-steps 80] [--ckpt-every 40]
      [--order io,base,base,io]

Trains a full-width model in bf16 through its kernels (tinyllama-1.1b: flash
attention; mamba2-2.7b: the SSD scan; zamba2-1.2b: both), batch 4 x 1024
tokens:
  1. ``--steps`` train steps after a warm-up one, each cut at device
     synchronisations into the loss forward, the backward and AdamW (host
     clock); then one step under ``torch.profiler``: device-busy share, each
     kernel's device time, the matrix products', the top kernels; with
     ``--strategy``, the parameters are placed by that strategy on
     ``make_local_mesh()`` (NCCL at world size 1) and the steps run under
     ``mesh_context``, as ``chip_smoke.py``'s distributed phase runs them;
  2. with ``--overlap-steps``: ``train`` in the I/O-aware mode (``io``:
     asynchronous checkpoints, prefetched batches) and the baseline
     (``base``: synchronous checkpoints) in ``--order``, a checkpoint every
     ``--ckpt-every`` steps under ``build/``, deleted after each run; per
     run the wall time, the step times and, per save, the time it held the
     loop (of it the host copy), save to commit, the final wait and the
     overlap (``chip_smoke.train_run``), and the time the loop spent in the
     save's other parts (planning the shards, submitting the write and
     commit tasks, the directory GC). One JSON line a run.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
from profile_serve_torch import KERNEL  # noqa: E402  (each arch's kernel flags)


def step_parts(torch, model, params, opt_state, batch, opt):
    """One train step cut into (loss forward, backward, AdamW) seconds."""
    from repro_torch.optim import adamw_update
    sync = torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    loss = model.loss(params, batch)
    sync()
    t1 = time.perf_counter()
    loss.backward()
    sync()
    t2 = time.perf_counter()
    named = dict(params.named_parameters())
    _, opt_state, _ = adamw_update({k: p.grad for k, p in named.items()}, named,
                                   opt_state, opt)
    sync()
    t3 = time.perf_counter()
    for p in named.values():
        p.grad = None
    return opt_state, (t1 - t0, t2 - t1, t3 - t2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(KERNEL), default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--strategy", default=None,
                    help="run part 1 sharded by this strategy at world size 1")
    ap.add_argument("--overlap-steps", type=int, default=0)
    ap.add_argument("--ckpt-every", type=int, default=40)
    ap.add_argument("--order", default="io,base,base,io")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_train_torch: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from profile_serve_torch import MATMUL_OPS, busy_ms, kernel_ms, profiled
    from repro_torch.data import SyntheticCorpus
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import train as train_mod
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.configs import get_config

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    flags, knames = KERNEL[args.arch]
    cfg = get_config(args.arch).replace(**{f: True for f in flags})
    B, S = chip_smoke.TRAIN["batch"], chip_smoke.TRAIN["seq"]

    # 1. one step cut into its parts, then profiled
    model = Model(cfg)
    params = model.init(0, device="cuda")
    ctx = contextlib.nullcontext
    if args.strategy:
        from repro_torch.distributed import STRATEGIES, mesh_context, place, shard_params
        from repro_torch.launch.mesh import make_local_mesh
        mesh = make_local_mesh()

        def ctx():
            return mesh_context(mesh, STRATEGIES[args.strategy])
        with ctx():
            place(params, shard_params(params, model.logical_axes(params)))
    opt_state = adamw_init(params.state_dict())
    opt = AdamWConfig()
    corpus = SyntheticCorpus(cfg.vocab_size, S, B, seed=0)
    parts = []
    for step in range(args.steps + 1):
        batch = {k: torch.from_numpy(v).cuda() for k, v in corpus.batch(step).items()}
        with ctx():
            opt_state, p = step_parts(torch, model, params, opt_state, batch, opt)
        parts.append(p)
    fwd, bwd, adam = (statistics.median(x) for x in zip(*parts[1:]))
    print(f"[step] {args.arch} {args.strategy or 'unsharded'} B={B} S={S} bf16 (median of {args.steps} after a warm-up): "
          f"forward {fwd:.4f} s, backward {bwd:.4f} s, AdamW {adam:.4f} s, "
          f"sum {fwd + bwd + adam:.4f} s; all {parts}")

    def one_step():
        nonlocal opt_state
        with ctx():
            opt_state, _ = step_parts(torch, model, params, opt_state, batch, opt)
    wall, kernels, prof = profiled(torch, one_step)
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    kern = kernel_ms(kernels, knames)
    mm_ms = sum(a.self_device_time_total for a in prof.key_averages()
                if a.key in MATMUL_OPS) / 1e3
    print(f"[profile] one step: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall:.1f}%), {len(kernels)} device kernels; "
          + "; ".join(f"{k} {ms:.2f} ms over {n} launches ({100 * ms / busy:.1f}% of busy)"
                      for k, ms, n in kern)
          + f"; matrix products {mm_ms:.1f} ms ({100 * mm_ms / busy:.1f}%)")
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12)
    print("\n".join(table.splitlines()[:16]))
    del model, params, opt_state, prof, kernels
    torch.cuda.empty_cache()
    if args.strategy:
        import torch.distributed as dist
        dist.destroy_process_group()

    # 2. the I/O-aware mode against the baseline, mid-run checkpoints
    if not args.overlap_steps:
        return 0
    from repro_torch.checkpoint import manager as manager_mod
    spent: dict = {}

    def timed(name, fn):
        def wrapped(*a, **kw):
            t0 = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] = spent.get(name, 0.0) + time.monotonic() - t0
        return wrapped
    for name in ("plan_shards", "_write_shard_task", "_commit_task"):
        setattr(manager_mod, name, timed(name, getattr(manager_mod, name)))
    manager_mod.CheckpointManager._gc = timed("_gc", manager_mod.CheckpointManager._gc)
    kernels = [{"name": "flash_attention_fwd", "counter": ops.flash_attention},
               {"name": "ssd_scan_fwd", "counter": ssd_ops.ssd_scan}]
    root = ROOT / "build" / "profile_train"
    for i, mode in enumerate(args.order.split(",")):
        d = root / f"{mode}_{i}"
        shutil.rmtree(d, ignore_errors=True)
        spent.clear()
        _, _, num = chip_smoke.train_run(
            torch, train_mod, cfg, kernels, f"overlap_{mode}_{i}", steps=args.overlap_steps,
            ckpt_dir=str(d), ckpt_every=args.ckpt_every, io_aware=mode == "io", resume=False)
        shutil.rmtree(d, ignore_errors=True)
        num.pop("losses"), num.pop("gnorms")
        print(json.dumps({"mode": mode, "run": i, "save_parts_s": dict(spent), **num}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
