#!/usr/bin/env python3
"""One run of a cell with the port's own spans printed beside its result
line. Not part of a benchmark run.

  python3 bench/spans_probe.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell as ``bench/run.py`` does, with every runtime of the port
traced (``repro_torch.obs.FORCE``), and prints the result line with the
window's end-to-end numbers (``e2e``, with ``--trace 1`` too) and
``spans``:

* ``recorder``: per span name in the runtimes' recorders (``repro_torch.
  spans``), its count and seconds (total, median, largest), and every
  ``ckpt.*`` span in order. With ``--trace 0`` these are host times with
  the profiler off.
* ``device_events_named_as_spans`` (traced): device events that carry a
  span's name; 0 where the ranges have no device-side twin.
* ``adamw_host_ms`` (traced train cells): the host's time in the
  ``optim.adamw`` ranges a traced step, under the profiler.
* ``decode`` (traced serving cells): per traced ``bench.decode`` mark, the
  kernels that start inside it by the device's clock (what
  ``launches.decode`` counts) and the host's kernel-launch calls inside
  it (``LAUNCH_CALLS``); and over the steps, the launch calls' share of
  the ``model.decode`` ranges, the longest call, and the ms from a range's
  end to its mark's end (the device's tail after the last launch, the
  argmax and the read-back). A host that had to wait for room in the
  device's launch queue would show long launch calls and a long tail.
"""
import argparse
import bisect
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "bench" / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.lib import harness  # noqa: E402
from bench.lib.program_spans import ranges  # noqa: E402

#: the port's span names (docs/torch_spans.md)
SPANS = ("ckpt.save", "ckpt.to_host", "ckpt.wait", "optim.adamw", "model.decode")
#: the host's calls that put one kernel on the device's queue
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def recorder_summary(events) -> dict:
    """What the recorders hold of the port's spans (``events``: every
    recorder's events, in one list)."""
    spans = sorted((e for e in events if e["type"] == "span" and e["name"] in SPANS),
                   key=lambda e: e["t"])
    by: dict = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e["dur"])
    return {"by_name": {n: {"count": len(d), "total_s": sum(d),
                            "median_s": statistics.median(d), "max_s": max(d)}
                        for n, d in by.items()},
            "ckpt": [{"name": e["name"], "s": e["dur"], **e["args"]}
                     for e in spans if e["name"].startswith("ckpt.")]}


def decode_summary(trace) -> dict | None:
    """Kernels against launch calls in each traced decode step, and where
    the host's time in ``model.decode`` goes (see the module's doc)."""
    marks = trace.marks_named("bench.decode")
    if not marks:
        return None
    calls = [(s, e) for n, s, e in trace.host_ops if n in LAUNCH_CALLS]
    starts = [s for s, _ in calls]

    def calls_in(t0, t1):
        return calls[bisect.bisect_left(starts, t0):bisect.bisect_left(starts, t1)]

    dec = ranges(trace, "model.decode")
    kernels, launches, tails = [], [], []
    in_dec = dec_s = longest = 0.0
    for m in marks:
        _, m0, m1 = m
        kernels.append(sum(1 for k in trace.kernels_in(m)
                           if not k[0].startswith(("Memcpy", "Memset"))))
        launches.append(len(calls_in(m0, m1)))
        for d0, d1 in dec:
            if m0 <= d0 and d1 <= m1:
                tails.append((m1 - d1) / 1e3)
                dec_s += d1 - d0
                for s, e in calls_in(d0, d1):
                    in_dec += e - s
                    longest = max(longest, e - s)
    return {"kernels_by_device_start": kernels, "launch_calls": launches,
            "kernels_total": sum(kernels), "launch_calls_total": sum(launches),
            "launch_share_of_decode_pct": 100.0 * in_dec / dec_s if dec_s else None,
            "longest_launch_us": longest,
            "tail_ms_median": statistics.median(tails) if tails else None,
            "tail_ms_max": max(tails) if tails else None}


def summary(run, events) -> dict:
    out = {"recorder": recorder_summary(events)}
    t = run.trace
    if t is not None:
        out["device_events_named_as_spans"] = sum(1 for k in t.kernels if k[0] in SPANS)
        steps = t.marks_named("bench.train_step")
        if steps:
            opt = ranges(t, "optim.adamw")
            out["adamw_host_ms"] = sum(e - s for s, e in opt) / 1e3 / len(steps)
        out["decode"] = decode_summary(t)
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = harness.manifest()
    _, c, tr = harness.cell_files(args.workload, bench)
    import torch
    from repro_torch import obs
    if not torch.cuda.is_available():
        print("spans_probe: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    obs.FORCE = True
    run = harness.Run(args.workload, c, tr, args.seed, args.seconds, bool(args.trace))
    harness.execute(run)
    out, _ = harness.result(run, bench)
    out["e2e"] = run.e2e
    out["spans"] = summary(run, [e for _, rt in obs.RUNS if rt.trace() is not None
                                 for e in rt.trace().events])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
