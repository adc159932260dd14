#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

  python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits 3 without a result where the cell's CUDA devices are missing, and 4
where a module of JAX or of the JAX package was loaded.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or PyTorch keeps lies inside the checkout, at a
# fixed path (the port builds its kernels under build/kernels/ by itself)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "bench" / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
