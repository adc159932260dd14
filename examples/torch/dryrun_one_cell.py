"""Example: run one (arch x shape) cell of the port's dry-run on the faked
16x16 mesh and print its record (``repro_torch.launch.dryrun``): per
device flops, collective traffic and memory. The step runs on ``meta``
tensors, so ``--device`` is only checked, as every entry point of the port
checks it (CUDA unless ``--device cpu``). The faked process group is
process-wide: this script owns its process. A record already under
``artifacts/dryrun_torch/`` is printed as it is, unless ``--force``.

  PYTHONPATH=src python examples/torch/dryrun_one_cell.py [arch] [shape] [--device cpu] [--force]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="tinyllama-1.1b")
    ap.add_argument("shape", nargs="?", default="train_4k")
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    from repro_torch.device import resolve_device
    from repro_torch.launch.dryrun import run_cell
    resolve_device(args.device)
    rec = run_cell(args.arch, args.shape, "single", force=args.force)
    print({k: rec[k] for k in ("arch", "shape", "status") if k in rec})
    if rec["status"] == "ok":
        print({k: rec[k] for k in ("trace_s", "n_devices", "flops", "collectives", "memory")})
    elif rec["status"] == "error":
        print(rec["traceback"])
        sys.exit(1)
