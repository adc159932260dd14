"""Serving example on the port: batched prefill+decode with I/O-task trace
dumps (``repro_torch.launch.serve``), the tinyllama-1.1b smoke config.

  PYTHONPATH=src python examples/torch/serve_batched.py [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import serve

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    args = ap.parse_args()
    trace = tempfile.mktemp(suffix=".jsonl")
    out = serve(get_smoke_config("tinyllama-1.1b"), n_requests=6,
                prompt_len=24, max_new=8, batch=3, trace_path=trace, device=args.device)
    print(f"{out['requests']} requests, {out['tokens_per_s']:.1f} tok/s")
    n_lines = len(open(trace).readlines())
    print(f"trace records written by I/O tasks: {n_lines}")
    assert n_lines == out["requests"]
