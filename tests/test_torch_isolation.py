"""The port stands alone: no module of repro_torch, and not chip_smoke.py,
loads jax or anything of the JAX package; its entry points need CUDA unless
the CPU is asked for."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
mods = ["repro_torch.launch.serve", "chip_smoke"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "jaxlib", "repro.")))
print(json.dumps({"imported": mods, "bad": bad}))
"""


def test_port_and_chip_smoke_load_no_jax_and_no_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "repro_torch.launch.serve" in out["imported"]
    assert "repro_torch.kernels.flash_attention.ops" in out["imported"]
    assert out["bad"] == []


def test_chip_smoke_does_nothing_at_import():
    import chip_smoke  # noqa: F401  (its work runs under __main__ only)


def test_serve_without_device_needs_cuda(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(get_smoke_config("tinyllama-1.1b"), n_requests=1, prompt_len=4,
              max_new=1, batch=1)


def test_model_init_without_device_needs_cuda(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(get_smoke_config("tinyllama-1.1b")).init(0)
