#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the chip at the
cell's own size. Not part of a benchmark run.

  python3 bench/calibrate.py --workload <cell> --seeds 11 12 13 [--seconds 10]

Training cells: per seed, the lower-precision control (the reference with
every matrix product's operands in fp8, ``lib/quant.py``) and the fault
"half of the batch left out, the mean taken over the rest" (the reference
over the first half of the rows), each compared with the float32
reference as a run compares the program. A state left unchanged reads 1
on ``change_gap`` by construction. Serving cells: per seed, a run of the
program with a window of ``--seconds`` (its own reading), then the
control over the same prompts and served tokens: the gap, under the
float32 reference, of the token the control puts first at each position.
Prints one JSON line a seed, then the largest program reading and the
smallest control and fault readings of each number.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.lib import harness  # noqa: E402


def train_readings(c, tr, seed, device):
    from bench.drivers import train as drv
    ref = drv.reference(c, tr, seed, device)
    out = {}
    for what, kw in (("control", {"quant": "fp8"}),
                     ("half_batch", {"rows": range(tr["batch"] // 2)})):
        other = drv.reference(c, tr, seed, device, **kw)
        out[what] = drv.compare(other["losses"], other["g1"], other["change"], ref)
    return out


def serve_readings(cell, c, tr, seed, seconds, device):
    import torch
    from bench.drivers import serve as drv
    run = harness.Run(cell, c, tr, seed, seconds, False, device)
    harness.execute(run)
    mod = harness.model_module(c)
    gaps = []
    for (s, ref), (_, low) in zip(run.reference_pairs,
                                  drv.reference_logits(run, mod, run.finished, torch.device(
                                      device), quant="fp8")):
        gaps.append(drv.gaps_of(low.argmax(-1), ref))
    return {"program": dict(run.readings), "control": {"token_gap": max(gaps)},
            "waves": len(run.finished)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, c, tr = harness.cell_files(args.workload)
    rows = []
    for seed in args.seeds:
        if tr["driver"] == "train":
            r = train_readings(c, tr, seed, args.device)
        else:
            r = serve_readings(args.workload, c, tr, seed, args.seconds, args.device)
        r["seed"] = seed
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {}
    for r in rows:
        for what, readings in r.items():
            if not isinstance(readings, dict):
                continue
            for k, v in readings.items():
                key = f"{what}.{k}"
                f = max if what == "program" else min
                summary[key] = f(summary.get(key, v), v)
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
