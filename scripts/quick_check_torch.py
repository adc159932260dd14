"""A short build-and-check call for a kernel or model change of the port, on
one GPU, before ``chip_smoke.py`` measures it.

  python3 scripts/quick_check_torch.py

Builds the four CUDA sources afresh (ptxas's registers and spills printed),
then runs ``chip_smoke.py``'s checks at small cost: K1 at head dim 80 in
every dtype route (the test cases and hubert-xlarge's shape), the masked
keys, K1's numbers at the main paths' shapes in bf16, one full-width
qwen2-moe-a2.7b MoE layer on the card against the CPU, the fp32 prefills of
qwen2-moe-a2.7b (2 layers), hubert-xlarge (2) and llava-next-mistral-7b
(1) kernels on against off, ``serve`` on qwen2-moe (2 layers) and mixtral
(1 layer), llava's prefill and decode (2 layers), phase 6's gradients of
hubert and qwen2-moe, and 2 train steps of qwen2-moe (1 layer) and
hubert-xlarge (4 layers). Each check that fails is reported and the others
still run; the exit code is 1 if any failed.
"""
from __future__ import annotations

import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("quick_check_torch: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import attention_ref, ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import Model

    t0 = time.monotonic()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    print(f"[build] {cs.build_all([*ops.SOURCES, *ssd_ops.SOURCES]):.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    K1, K2 = "flash_attention_fwd", "ssd_scan_fwd"
    kernels = [{"name": K1, "counter": ops.flash_attention},
               {"name": K2, "counter": ssd_ops.ssd_scan}]
    failed = []

    def check(name, fn, *args, **kw):
        try:
            fn(*args, **kw)
        except Exception as e:              # report it, run the other checks
            traceback.print_exc()
            failed.append(name)
            print(f"FAILED {name}: {e!r}", flush=True)

    for case in cs.HD80_CASES + [cs.FAMILY_FLASH_CASES["hubert-xlarge"]]:
        for dtype in cs.FLASH_DTYPES:
            check(f"flash {case} {dtype}", cs.check_flash, torch, ops, attention_ref, case,
                  dtype)
    for dtype in ("bfloat16", "float16"):
        check(f"flash window=1 {dtype}", cs.check_flash_masked, torch, ops, dtype)
    for case in [cs.SLICE_CASE, cs.ZAMBA_FLASH_CASE, *cs.FAMILY_FLASH_CASES.values()]:
        check(f"flash {case} timed", cs.check_flash, torch, ops, attention_ref, case,
              "bfloat16", timed=True)
    check("moe layer", cs.check_moe_layer, torch, get_config("qwen2-moe-a2.7b"))
    for arch, layers in (("qwen2-moe-a2.7b", 2), ("hubert-xlarge", 2),
                         ("llava-next-mistral-7b", 1)):
        cfg = get_config(arch).replace(dtype=torch.float32, n_layers=layers)
        check(f"prefill {arch}", cs.check_prefill, torch, np, Model, cfg, kernels,
              ("use_flash",), {K1: layers, K2: 0})
    qwen = get_config("qwen2-moe-a2.7b").replace(use_flash=True, n_layers=2)
    check("serve qwen2-moe", cs.serve_path, torch, serve_mod, Model, qwen, kernels,
          n_requests=4, max_new=8)
    mixtral = get_config("mixtral-8x22b").replace(use_flash=True, n_layers=1)
    check("serve mixtral", cs.serve_path, torch, serve_mod, Model, mixtral, kernels,
          **cs.MIXTRAL_SERVE)
    llava = get_config("llava-next-mistral-7b").replace(use_flash=True, n_layers=2)
    check("llava", cs.vlm_path, torch, np, Model, llava, kernels)
    for arch in ("hubert-xlarge", "qwen2-moe-a2.7b"):
        check(f"grads {arch}", cs.check_train_grads, torch, np, Model,
              get_config(arch).replace(dtype=torch.float32), kernels, ("use_flash",),
              {K1: 4, K2: 0})
    check("train qwen2-moe", cs.train_steps, torch, train_mod, qwen.replace(n_layers=1),
          kernels, "quick_moe", {K1: 2, K2: 0})
    check("train hubert", cs.encoder_train, torch, np, train_mod, Model,
          get_config("hubert-xlarge").replace(use_flash=True, n_layers=4), kernels)
    print(f"[quick_check] {time.monotonic() - t0:.1f} s; failed: {failed or 'none'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
