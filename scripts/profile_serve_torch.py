"""Where the time of the port's serving path goes, on one GPU.

  python3 scripts/profile_serve_torch.py [--max-new 16] [--out build/profile_serve.txt]

Serves full-width tinyllama-1.1b (bf16, flash kernel) through
``repro_torch.launch.serve`` once to warm up, then once more under
``torch.profiler``, and prints: the wall time, the device-busy share of it
(the union of kernel intervals over the profiled window), the flash
kernel's share, and the top kernels by device time. The full table goes to
``--out``.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_serve.txt"))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_serve_torch: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = get_config("tinyllama-1.1b").replace(use_flash=True)
    kw = dict(n_requests=args.requests, batch=args.batch,
              prompt_len=args.prompt_len, max_new=args.max_new, device="cuda")
    serve(cfg, **kw)                                    # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = serve(cfg, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    flash = sum(e.time_range.elapsed_us() for e in kernels
                if "flash_fwd" in e.name) / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(table)
    steps = args.max_new * -(-args.requests // args.batch)
    print(f"[profile] wall {wall * 1e3:.1f} ms for {out['new_tokens']} tokens "
          f"({steps} decode steps, {out['tokens_per_s']:.2f} tok/s); "
          f"device busy {busy:.1f} ms = {100 * busy / (wall * 1e3):.1f}% of wall; "
          f"flash kernel {flash:.2f} ms over {len([e for e in kernels if 'flash_fwd' in e.name])} "
          f"launches; {len(kernels)} kernel launches in all")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12))
    return 0


if __name__ == "__main__":
    sys.exit(main())
