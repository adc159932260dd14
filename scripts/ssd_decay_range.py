"""How far the SSD scan's decay sums reach at full width, against fp32's
exp range.

  python3 scripts/ssd_decay_range.py [--arch mamba2-2.7b] [--seed 0]

Runs the forward of a full-width model in bf16 (random weights from
``--seed``, the first batch ``train`` would take, 4 x 1024 tokens) layer by
layer and prints, for every layer, the largest sum of the step decays
``-la = dt * exp(A_log)`` over one chunk: the largest ``seg`` above the
diagonal of the chunk's decay matrix. Where it passes log(fp32 max) =
88.72, ``exp(seg)`` overflows, and the reference's ``where(causal,
exp(seg), 0)`` has a NaN gradient (the port masks before the exp).
"""
from __future__ import annotations

import argparse
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EXP_LIMIT = math.log(3.4028234663852886e38)     # 88.72


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-2.7b")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("ssd_decay_range: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.models import Model
    from repro_torch.models.layers import embed_lookup, rmsnorm
    from repro_torch.models.mamba2 import ssm_layer

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = get_config(args.arch)
    params = Model(cfg).init(args.seed, device="cuda")
    batch = SyntheticCorpus(cfg.vocab_size, 1024, 4, seed=args.seed).batch(0)
    h = embed_lookup(params.embed, torch.from_numpy(batch["tokens"]).cuda())
    Q = cfg.ssm_chunk
    sums = []
    with torch.no_grad():
        for lp in params.layers:
            u = rmsnorm(h, lp.ln, cfg.norm_eps)
            dt = F.softplus((u @ lp.in_dt).float() + lp.dt_bias)          # (b, S, H)
            decay = (dt * torch.exp(lp.A_log)).reshape(dt.shape[0], -1, Q, dt.shape[-1])
            sums.append((decay[:, :, 1:].sum(2)).max().item())
            h = ssm_layer(lp, h, cfg)
    over = [i for i, s in enumerate(sums) if s > EXP_LIMIT]
    print(f"[decay] {cfg.name} bf16 seed {args.seed}, chunk {Q}: largest decay sum "
          f"above a chunk's diagonal, by layer: {[round(s, 2) for s in sums]}")
    print(f"[decay] range {min(sums):.2f}-{max(sums):.2f}; {len(over)} of {len(sums)} "
          f"layers past {EXP_LIMIT:.2f} (exp overflows in fp32): {over}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
