"""End-to-end example on the port: train a small LM with async,
auto-constrained checkpoint shards overlapping the train steps, then
kill/resume (``repro_torch.launch.train``).

  PYTHONPATH=src python examples/torch/train_with_io_aware_checkpointing.py [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.launch.train import PRESETS, train

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the current CUDA device")
    device = ap.parse_args().device
    ckpt = tempfile.mkdtemp(prefix="repro_ck_")
    print(f"checkpoints -> {ckpt}")
    out = train(PRESETS["5m"], steps=12, batch=2, seq=64, ckpt_dir=ckpt,
                ckpt_every=4, io_aware=True, device=device)
    print(f"phase 1: {out['steps_run']} steps, "
          f"loss {out['losses'][0]:.3f} -> {out['final_loss']:.3f}")
    out = train(PRESETS["5m"], steps=20, batch=2, seq=64, ckpt_dir=ckpt,
                ckpt_every=4, io_aware=True, resume=True, device=device)
    print(f"phase 2 (resumed): {out['steps_run']} steps, "
          f"final loss {out['final_loss']:.3f}")
    assert out["steps_run"] < 20, "resume must skip completed steps"
    print("resume OK — fault-tolerant restart works")
