"""Where the time of the port's serving path goes, on one GPU.

  python3 scripts/profile_serve_torch.py [--arch tinyllama-1.1b|mamba2-2.7b|zamba2-1.2b|
      qwen2-moe-a2.7b] [--max-new 16] [--out build/profile_serve_<arch>.txt]

Serves a full-width model in bf16 through its kernels (tinyllama-1.1b and
qwen2-moe-a2.7b: flash attention; mamba2-2.7b: the SSD scan; zamba2-1.2b:
both) via
``repro_torch.launch.serve``
once to warm up, then profiles under ``torch.profiler``:
  1. one prefill wave alone: wall, device-busy time, each kernel's device
     time and the matrix products' (``aten::mm``/``bmm``/``addmm``);
  2. decode steps alone: wall a step, kernel launches a step, device-busy
     share;
  3. one whole ``serve`` run: wall, device-busy share of it (the union of
     kernel intervals over the profiled window), the kernel's share, and
     the top kernels by device time. The full table goes to ``--out``.
For an MoE model the prefill and decode lines also split the device time
between the expert products (``aten::bmm``; in decode it also holds the
attention's two einsums over the cache) and the dispatch's routing and
gather/scatter ops (``DISPATCH_OPS``).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the kernels each model's serving path runs: (config flags, a substring of
# each kernel's device-kernel names; "flash_fwd" matches both flash routes,
# the bf16/fp16 flash_fwd_sm90_kernel and the fp32 flash_fwd_kernel; "ssd_"
# every kernel of both SSD routes: the bf16 route's C.B^T pass ssd_cb_kernel
# and its scan ssd_scan_sm90_kernel, two launches a call, and the fp32
# ssd_fwd_kernel)
KERNEL = {"tinyllama-1.1b": (("use_flash",), ("flash_fwd",)),
          "mamba2-2.7b": (("use_ssd_kernel",), ("ssd_",)),
          "zamba2-1.2b": (("use_flash", "use_ssd_kernel"), ("flash_fwd", "ssd_")),
          "qwen2-moe-a2.7b": (("use_flash",), ("flash_fwd",))}
MATMUL_OPS = ("aten::mm", "aten::bmm", "aten::addmm")
# the ops of models/moe.py's dispatch besides its products: routing (softmax,
# top-k, sorts, counts) and the moves into and out of the expert slots
DISPATCH_OPS = ("aten::_softmax", "aten::topk", "aten::sort", "aten::argsort",
                "aten::index_add_", "aten::cumsum", "aten::index", "aten::index_copy",
                "aten::index_copy_", "aten::scatter_", "aten::cat", "aten::where",
                "aten::sum", "aten::div", "aten::mean")


def busy_ms(intervals):
    """Length of the union of (start, end) intervals, in ms (inputs in us)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def kernel_ms(kernels, knames):
    """``name: device ms over n launches`` for each name of ``knames``."""
    parts = []
    for kname in knames:
        kern = [e for e in kernels if kname in e.name]
        ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        parts.append((kname, ms, len(kern)))
    return parts


def moe_split(prof, cfg):
    """``; expert products x ms, dispatch ops y ms`` for an MoE model (self
    device time by op name), else ``""``."""
    if not cfg.n_experts:
        return ""
    by = {a.key: a.self_device_time_total / 1e3 for a in prof.key_averages()}
    disp = sum(by.get(k, 0.0) for k in DISPATCH_OPS)
    return f"; bmm {by.get('aten::bmm', 0.0):.2f} ms, dispatch ops {disp:.2f} ms"


def profiled(torch, fn):
    """Run ``fn`` under the profiler; returns (wall ms, device kernels,
    profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return wall, kernels, prof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(KERNEL), default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_serve_torch: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import Model

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    flags, knames = KERNEL[args.arch]
    cfg = get_config(args.arch).replace(**{f: True for f in flags})
    kw = dict(n_requests=args.requests, batch=args.batch,
              prompt_len=args.prompt_len, max_new=args.max_new, device="cuda")
    serve(cfg, **kw)                                    # warm-up

    # 1-2. one prefill wave, then decode steps, each alone
    model = Model(cfg)
    params = model.init(0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                         generator=gen, device="cuda")
    box = {}

    def prefill():
        box["logits"], box["state"] = model.prefill(
            params, {"tokens": toks}, args.prompt_len + args.max_new)

    def decode():
        for _ in range(args.max_new):
            nxt = box["logits"][:, :cfg.vocab_size].argmax(-1)
            nxt.tolist()                   # serve's one sync a step
            box["logits"], box["state"] = model.decode_step(params, box["state"], nxt)

    wall, kernels, prof = profiled(torch, prefill)
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    kern = kernel_ms(kernels, knames)
    kern_ms = sum(ms for _, ms, _ in kern)
    mm_ms = sum(a.self_device_time_total for a in prof.key_averages()
                if a.key in MATMUL_OPS) / 1e3
    print(f"[prefill] {args.arch} B={args.batch} S={args.prompt_len}: wall {wall:.1f} ms, "
          f"device busy {busy:.1f} ms; "
          + "; ".join(f"{k} {ms:.2f} ms over {n} launches ({100 * ms / busy:.1f}% of "
                      f"device busy)" for k, ms, n in kern)
          + f"; matrix products {mm_ms:.2f} ms; other {busy - kern_ms - mm_ms:.2f} ms; "
          f"{len(kernels)} kernel launches" + moe_split(prof, cfg))
    wall, kernels, prof = profiled(torch, decode)
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    mm_ms = sum(a.self_device_time_total for a in prof.key_averages()
                if a.key in MATMUL_OPS) / 1e3
    print(f"[decode] {args.arch} B={args.batch}, {args.max_new} steps: "
          f"{wall / args.max_new:.2f} ms a step, {len(kernels) / args.max_new:.0f} kernel "
          f"launches a step, device busy {busy / args.max_new:.2f} ms a step = "
          f"{100 * busy / wall:.1f}% of wall; matrix products "
          f"{mm_ms / args.max_new:.2f} ms a step" + moe_split(prof, cfg)
          + (" (all steps)" if cfg.n_experts else ""))
    del params
    box.clear()
    torch.cuda.empty_cache()

    # 3. one whole serve run
    wall, kernels, prof = profiled(torch, lambda: box.update(out=serve(cfg, **kw)))
    out = box["out"]
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    kern = kernel_ms(kernels, knames)
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)
    dest = Path(args.out or ROOT / "build" / f"profile_serve_{args.arch}.txt")
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(table)
    steps = args.max_new * -(-args.requests // args.batch)
    print(f"[profile] {args.arch}: wall {wall:.1f} ms for {out['new_tokens']} tokens "
          f"({steps} decode steps, {out['tokens_per_s']:.2f} tok/s); "
          f"device busy {busy:.1f} ms = {100 * busy / wall:.1f}% of wall; "
          + "".join(f"{k} {ms:.2f} ms over {n} launches; " for k, ms, n in kern)
          + f"{len(kernels)} kernel launches in all")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12))
    return 0


if __name__ == "__main__":
    sys.exit(main())
