"""The port stands alone: no module of repro_torch, and not chip_smoke.py,
loads jax or anything of the JAX package; its entry points need CUDA unless
the CPU is asked for."""
import ast
import importlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
mods = ["repro_torch.launch.serve", "repro_torch.launch.train", "chip_smoke"] + [
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
    assert "repro_torch.kernels.ssd_scan.ops" in out["imported"]
    for mod in ("launch.train", "optim.adamw", "checkpoint.manager", "checkpoint.serializer",
                "data.pipeline", "convert", "models.zamba2", "models.moe", "lint", "trace",
                "compare"):
        assert f"repro_torch.{mod}" in out["imported"]
    assert out["bad"] == []


# The port's scripts import the package inside main(), after their CUDA check,
# so a renamed name only shows on the card. Resolve every name they take from
# the port: ``from m import a``, and ``alias.a`` on a module they imported.
PORT_SCRIPTS = ["chip_smoke.py"] + sorted(
    f"scripts/{p.name}" for p in (ROOT / "scripts").glob("*.py")
    if "repro_torch" in p.read_text())
PORT_MODULES = ("repro_torch", "chip_smoke", "profile_serve_torch", "test_torch_")


def _lookup(mod, name):
    """``mod.name`` (an attribute or a submodule), or None."""
    m = importlib.import_module(mod)
    if hasattr(m, name):
        return getattr(m, name)
    if hasattr(m, "__path__") and importlib.util.find_spec(f"{mod}.{name}") is not None:
        return importlib.import_module(f"{mod}.{name}")
    return None


def _missing_names(tree):
    """The names a script takes from the port that do not resolve. Each
    top-level function is one scope of aliases, the module's own statements
    another."""
    functions = [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    top = ast.Module([n for n in tree.body if n not in functions], [])
    missing, n_names = [], 0
    for scope in [top] + functions:
        aliases = {}                    # alias -> the modules it is bound to here
        for node in ast.walk(scope):
            if isinstance(node, ast.Import):
                aliases.update({a.asname or a.name: {importlib.import_module(a.name)}
                                for a in node.names if a.name.startswith(PORT_MODULES)})
            elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith(PORT_MODULES):
                for a in node.names:
                    n_names += 1
                    obj = _lookup(node.module, a.name)
                    if obj is None:
                        missing.append(f"{node.module}.{a.name}")
                    elif isinstance(obj, types.ModuleType):
                        aliases.setdefault(a.asname or a.name, set()).add(obj)
        for node in ast.walk(scope):
            if (isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Load)
                    and isinstance(node.value, ast.Name) and node.value.id in aliases):
                n_names += 1
                mods = aliases[node.value.id]
                if not any(_lookup(m.__name__, node.attr) is not None for m in mods):
                    missing.append(f"{node.value.id}.{node.attr}")
    return missing, n_names


@pytest.mark.parametrize("script", PORT_SCRIPTS)
def test_port_scripts_name_only_what_the_port_has(script, monkeypatch):
    for d in ("src", "scripts", "tests", ""):
        monkeypatch.syspath_prepend(str(ROOT / d))
    missing, n_names = _missing_names(ast.parse((ROOT / script).read_text()))
    assert n_names > 0
    assert missing == [], f"{script} names what the port does not have"


def test_chip_smoke_does_nothing_at_import():
    import chip_smoke  # noqa: F401  (its work runs under __main__ only)


def test_serve_without_device_needs_cuda(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(get_smoke_config("tinyllama-1.1b"), n_requests=1, prompt_len=4,
              max_new=1, batch=1)


def test_train_without_device_needs_cuda(monkeypatch, tmp_path):
    from repro_torch.launch.train import PRESETS, train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(PRESETS["5m"], steps=1, batch=1, seq=8, ckpt_dir=str(tmp_path),
              ckpt_every=1)
    assert not any(tmp_path.iterdir())      # nothing written before the check


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-2.7b", "zamba2-1.2b",
                                  "qwen2-moe-a2.7b", "hubert-xlarge", "llava-next-mistral-7b"])
def test_model_init_without_device_needs_cuda(monkeypatch, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(get_smoke_config(arch)).init(0)
