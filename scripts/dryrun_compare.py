"""The port's dry-run beside the JAX package's, on the CPU.

  PYTHONPATH=src python scripts/dryrun_compare.py production [--archs a b ...] \
      [--meshes single multi] [--packages jax port]
  PYTHONPATH=src python scripts/dryrun_compare.py smoke

``production``: every (arch x shape x mesh) cell through both packages'
``run_cell``: ``repro.launch.dryrun`` lowering and compiling for 256 or 512
faked XLA host devices on a mesh with ``Auto`` axes (its own
``make_production_mesh`` gives ``Explicit`` axes, on which jax 0.9 refuses
the step), and ``repro_torch.launch.dryrun`` tracing on ``meta`` as rank 0
of a faked group. Prints one markdown row a cell: both statuses, the
compile and trace times, and each package's per-device flops, collective
bytes and argument / temp bytes (XLA counts a ``lax.scan`` body once, so
the reference's flops and collectives of a scanned model are one layer's
worth; the port loops in Python and counts every layer).

``smoke``: the tinyllama, mamba2, zamba2 and qwen2-moe smoke configs'
train, prefill and decode cells at batch 8 x 64 tokens on a (4, 2) mesh:
the JAX program compiled for 8 faked devices (``Auto`` axes), its
``cost_analysis`` flops and ``parse_collectives`` bytes per device, beside
the port's traced flops and collective bytes on rank 0 of a faked group of
8. GSPMD and DTensor place collectives differently; no ratio is expected.

Each package runs in a process of its own (the device count and the faked
group are process-wide). Records go under ``artifacts/dryrun_compare/``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "artifacts" / "dryrun_compare"
SMOKE_ARCHS = ["tinyllama-1.1b", "mamba2-2.7b", "zamba2-1.2b", "qwen2-moe-a2.7b"]

JAX_PRODUCTION = r"""
import json, sys
import repro.launch.dryrun as d          # sets the 512-device XLA flag first
import jax
from pathlib import Path
from jax.sharding import AxisType
archs, meshes, out = json.loads(sys.argv[1])


def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))


d.make_production_mesh = auto_mesh
d.ARTIFACTS = Path(out)
recs = {}
for a in archs:
    for s in d.SHAPES:
        for m in meshes:
            r = d.run_cell(a, s, m, force=True)
            recs[f"{a}|{s}|{m}"] = {k: v for k, v in r.items() if k != "cost_analysis"}
            print(a, s, m, r["status"], flush=True)
json.dump(recs, open(Path(out) / "all.json", "w"))
"""

PORT_PRODUCTION = r"""
import json, sys
from pathlib import Path
import repro_torch.launch.dryrun as d
archs, meshes, out = json.loads(sys.argv[1])
d.ARTIFACTS = Path(out)
recs = {}
for a in archs:
    for s in d.SHAPES:
        for m in meshes:
            recs[f"{a}|{s}|{m}"] = d.run_cell(a, s, m, force=True)
            print(a, s, m, recs[f"{a}|{s}|{m}"]["status"], flush=True)
json.dump(recs, open(Path(out) / "all.json", "w"))
"""

JAX_SMOKE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
from repro.compat import cost_analysis_dict
from repro.configs import get_smoke_config
from repro.configs.base import ShapeCell
from repro.distributed import mesh_context
from repro.distributed.sharding import STRATEGIES
from repro.launch.dryrun import parse_collectives
from repro.launch.specs import build_cell
archs, B, S, out = json.loads(sys.argv[1])
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
recs = {}
for a in archs:
    for kind in ("train", "prefill", "decode"):
        with mesh_context(mesh, rules=STRATEGIES["tp_fsdp"]):
            fn, args, out_sh = build_cell(get_smoke_config(a), ShapeCell(kind, S, B, kind), mesh)
            jitted = jax.jit(fn, out_shardings=out_sh) if out_sh else jax.jit(fn)
            c = jitted.lower(*args).compile()
        recs[f"{a}|{kind}"] = {"flops": float(cost_analysis_dict(c)["flops"]),
                               "collectives": parse_collectives(c.as_text())}
json.dump(recs, open(out, "w"))
"""

PORT_SMOKE = r"""
import json, sys
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.dryrun import fake_mesh, trace_cell
archs, B, S, out = json.loads(sys.argv[1])
mesh = fake_mesh((4, 2), ("data", "model"))
json.dump({f"{a}|{kind}": trace_cell(get_smoke_config(a), ShapeCell(kind, S, B, kind), mesh)
           for a in archs for kind in ("train", "prefill", "decode")}, open(out, "w"))
"""


def run_both(jax_script, port_script, jax_arg, port_arg, packages=("jax", "port")):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("JAX_PLATFORMS", "cpu")
    jobs = {"jax": (jax_script, jax_arg), "port": (port_script, port_arg)}
    procs = [subprocess.Popen([sys.executable, "-c", script, json.dumps(arg)], cwd=ROOT,
                              env=env)
             for pkg, (script, arg) in jobs.items() if pkg in packages]
    for p in procs:
        p.wait()
    if any(p.returncode for p in procs):
        sys.exit(f"exit codes {[p.returncode for p in procs]}")


def _e(x):
    return "—" if x is None else f"{x:.3e}"


def production(archs, meshes, packages):
    """Runs ``packages`` (the other's last records are read back)."""
    dirs = {pkg: OUT / f"production_{pkg}" for pkg in ("jax", "port")}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    run_both(JAX_PRODUCTION, PORT_PRODUCTION, [archs, meshes, str(dirs["jax"])],
             [archs, meshes, str(dirs["port"])], packages)
    recs = {pkg: json.loads((d / "all.json").read_text()) for pkg, d in dirs.items()}
    print("| arch | shape | mesh | JAX (Auto) | port | compile / trace s | flops JAX / port "
          "| collective B JAX / port | arg B JAX / port | temp B JAX / port |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for key, j in recs["jax"].items():
        if key not in recs["port"]:
            continue
        p = recs["port"][key]
        a, s, m = key.split("|")
        row = [a, s, m, j["status"], p["status"]]
        if j["status"] == "skipped" or p["status"] == "skipped":
            row += [j.get("reason") or p.get("reason"), "", "", "", ""]
        else:
            jm, pm = j.get("memory", {}), p.get("memory", {})
            row += [f"{j.get('compile_s', '—')} / {p.get('trace_s', '—')}",
                    f"{_e(j.get('flops'))} / {_e(p.get('flops'))}",
                    f"{_e(j.get('collectives', {}).get('total_bytes'))} / "
                    f"{_e(p.get('collectives', {}).get('total_bytes'))}",
                    f"{_e(jm.get('argument_size_in_bytes'))} / "
                    f"{_e(pm.get('argument_size_in_bytes'))}",
                    f"{_e(jm.get('temp_size_in_bytes'))} / {_e(pm.get('temp_size_in_bytes'))}"]
        print("| " + " | ".join(str(x) for x in row) + " |")
    for pkg, r in recs.items():
        for key, rec in r.items():
            if rec["status"] == "error":
                print(f"{pkg} {key}: {rec['error'][:300]}")


def smoke():
    OUT.mkdir(parents=True, exist_ok=True)
    files = {pkg: OUT / f"smoke_{pkg}.json" for pkg in ("jax", "port")}
    run_both(JAX_SMOKE, PORT_SMOKE, [SMOKE_ARCHS, 8, 64, str(files["jax"])],
             [SMOKE_ARCHS, 8, 64, str(files["port"])])
    recs = {pkg: json.loads(f.read_text()) for pkg, f in files.items()}
    print("| arch | cell | flops JAX / port | collective B JAX / port | "
          "JAX by op | port by op |")
    print("|---|---|---|---|---|---|")
    for key, j in recs["jax"].items():
        p = recs["port"][key]
        a, kind = key.split("|")

        def by_op(c):
            return ", ".join(f"{k} {v:.3g}" for k, v in sorted(c["bytes_by_op"].items()))
        print(f"| {a} | {kind} 8 x 64 | {_e(j['flops'])} / {_e(p['flops'])} | "
              f"{_e(j['collectives']['total_bytes'])} / {_e(p['collectives']['total_bytes'])} "
              f"| {by_op(j['collectives'])} | {by_op(p['collectives'])} |")


def main():
    from repro_torch.configs import ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("part", choices=["production", "smoke"])
    ap.add_argument("--archs", nargs="*", default=ARCHS)
    ap.add_argument("--meshes", nargs="*", default=["single", "multi"])
    ap.add_argument("--packages", nargs="*", default=["jax", "port"])
    args = ap.parse_args()
    if args.part == "production":
        production(args.archs, args.meshes, args.packages)
    else:
        smoke()


if __name__ == "__main__":
    main()
