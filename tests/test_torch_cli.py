"""The port's CLIs (``python -m repro_torch.lint``, ``.trace``, ``.compare``)
against the JAX package's (``repro.lint``, ``.trace``, ``.compare``): each
script is written once against ``repro_torch.core`` and once, the same text
with ``repro_torch`` replaced by ``repro``, against the JAX package's
runtime; each CLI runs in a subprocess over its own package's script. No
assertion reads a measured duration."""
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKGS = ("repro_torch", "repro")
# each package's scripts in a directory of its own, the names of one length,
# so that the summaries' underlines match too
DIRS = {"repro_torch": "port", "repro": "jaxp"}

DIRTY = """\
from repro_torch.core import Cluster, IORuntime, constraint, io, task
@constraint(tier='tape')
@io
@task(returns=1)
def wr(x): pass
with IORuntime(Cluster.make_tiered(n_workers=2)) as rt:
    wr(1, io_mb=4)
"""
CLEAN = """\
from repro_torch.core import Cluster, IORuntime, task
@task(returns=1)
def f(x): pass
with IORuntime(Cluster.make_tiered(n_workers=2)) as rt:
    f(1)
"""
# a Cluster, an IORuntime on the simulator and a few @io tasks that write
# real files when the compare CLI's measured leg runs them
TASKS = """\
import os
from repro_torch.core import (Cluster, IORuntime, SimBackend, StorageDevice,
                              WorkerNode, io, task)
@io
@task(returns=1)
def put(dirpath, name, mb):
    if dirpath:
        with open(os.path.join(dirpath, name), 'wb') as f:
            f.write(b'x' * int(mb * (1 << 20)))
            f.flush()
            os.fsync(f.fileno())
    return name
dev = StorageDevice(name='d0', tier='ssd')
cluster = Cluster(workers=[WorkerNode(name='w0', cpus=1, io_executors=4, tiers=[dev])])
with IORuntime(cluster, backend=SimBackend()) as rt:
    for i in range(3):
        put(OUT, f'f{i}.bin', 0.25, io_mb=0.25, storage_tier='ssd')
    rt.barrier(final=True)
"""


def write_scripts(tmp_path, text, name, out_dir=None):
    """``{package: path}``: ``text`` for the port, and the same text with
    ``repro_torch`` replaced by ``repro`` for the JAX package."""
    paths = {}
    for pkg in PKGS:
        d = tmp_path / DIRS[pkg]
        d.mkdir(exist_ok=True)
        body = text.replace("repro_torch", pkg)
        if out_dir is not None:
            o = d / out_dir
            o.mkdir(exist_ok=True)
            body = body.replace("OUT", repr(str(o)))
        paths[pkg] = d / name
        paths[pkg].write_text(body)
    return paths


def run_cli(pkg, cli, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.run([sys.executable, "-m", f"{pkg}.{cli}", *map(str, args)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)


@pytest.mark.parametrize("kind,want_rc", [("dirty", 1), ("clean", 0)])
def test_lint_matches_the_jax_package(kind, want_rc, tmp_path):
    paths = write_scripts(tmp_path, DIRTY if kind == "dirty" else CLEAN, f"{kind}.py")
    runs = {pkg: run_cli(pkg, "lint", paths[pkg]) for pkg in PKGS}
    lines = {pkg: r.stdout.replace(str(paths[pkg]), "SCRIPT").splitlines()
             for pkg, r in runs.items()}
    assert [r.returncode for r in runs.values()] == [want_rc, want_rc], \
        {pkg: r.stderr for pkg, r in runs.items()}
    assert lines["repro_torch"] == lines["repro"]
    if kind == "clean":
        assert lines["repro"] == ["SCRIPT: clean"]
    else:
        assert any("IO102" in line for line in lines["repro_torch"])
        docs = {pkg: json.loads(run_cli(pkg, "lint", paths[pkg], "--json").stdout)
                for pkg in PKGS}
        for doc in docs.values():
            doc[0].pop("script")
        assert docs["repro_torch"] == docs["repro"]


def test_trace_matches_the_jax_package(tmp_path):
    paths = write_scripts(tmp_path, TASKS.replace("OUT", "None"), "tasks.py")
    counts, summaries = {}, {}
    for pkg in PKGS:
        pf = tmp_path / DIRS[pkg] / "trace.json"
        r = run_cli(pkg, "trace", paths[pkg], "--perfetto", pf)
        assert r.returncode == 0, r.stderr
        events = json.loads(pf.read_text())["traceEvents"]
        assert events
        counts[pkg] = Counter((e.get("ph"), e.get("cat"), e.get("name")) for e in events)
        summaries[pkg] = r.stdout.replace(str(paths[pkg]), "SCRIPT").splitlines()
    assert counts["repro_torch"] == counts["repro"]
    assert summaries["repro_torch"] == summaries["repro"]
    assert summaries["repro"][0].startswith("trace summary: SCRIPT runtime-1")


def test_compare_matches_the_jax_package(tmp_path):
    paths = write_scripts(tmp_path, TASKS, "tasks.py", out_dir="payload")
    docs = {}
    for pkg in PKGS:
        fit = tmp_path / DIRS[pkg] / "fit.json"
        r = run_cli(pkg, "compare", paths[pkg], "--tier-base", tmp_path / DIRS[pkg] / "tiers",
                    "--fit", fit, "--json")
        assert r.returncode == 0, r.stderr
        docs[pkg] = json.loads(r.stdout)
        fitted = json.loads(fit.read_text())
        assert set(fitted) == {"script", "tiers"} and "ssd" in fitted["tiers"]
        assert sorted((tmp_path / DIRS[pkg] / "payload").iterdir())     # the measured leg wrote
    t, j = docs["repro_torch"][0], docs["repro"][0]
    assert len(docs["repro_torch"]) == len(docs["repro"]) == 1
    assert t["report"]["n_pairs"] == j["report"]["n_pairs"] == 3
    assert t.keys() == j.keys() and "report_fitted" in t
    assert t["report"].keys() == j["report"].keys()
    assert t["tier_fit"].keys() == j["tier_fit"].keys()


@pytest.mark.parametrize("cli", ["lint", "trace", "compare"])
def test_missing_file_exits_2(cli):
    for pkg in PKGS:
        r = run_cli(pkg, cli, "/no/such/script.py")
        assert r.returncode == 2, (pkg, r.stderr)
        assert f"{pkg}.{cli}: no such file" in r.stderr


HOOKS = """\
import json
import repro.analysis.capture as rcap, repro.obs as robs
import repro_torch.analysis.capture as tcap, repro_torch.obs as tobs
from repro_torch.core import Cluster, IORuntime, SimBackend, io, task
@io
@task()
def w(i):
    pass
with IORuntime(Cluster.make(n_workers=1, cpus=2, io_executors=2),
               backend=SimBackend()) as rt:
    for i in range(2):
        w(i, io_mb=1.0)
    rt.barrier(final=True)
with open(HOOKS_OUT, 'a') as f:
    f.write(json.dumps({"repro": [rcap.FORCE, robs.FORCE, robs.FORCE_BACKEND is not None],
                        "repro_torch": [tcap.FORCE, tobs.FORCE,
                                        tobs.FORCE_BACKEND is not None]}) + "\\n")
"""


@pytest.mark.parametrize("cli,want", [("lint", [True, False, False]),
                                      ("trace", [False, True, False]),
                                      ("compare", [False, True, True])])
def test_port_clis_set_only_the_ports_hooks(cli, want, tmp_path, monkeypatch):
    """In-process: while the script runs, the port's capture/trace/backend
    hooks are set as the CLI needs them and the JAX package's stay unset;
    both are unset after."""
    import importlib

    import repro.analysis.capture as rcap
    import repro.obs as robs
    import repro_torch.analysis.capture as tcap
    import repro_torch.obs as tobs
    out = tmp_path / "hooks.jsonl"
    script = tmp_path / "hooks.py"
    script.write_text(HOOKS.replace("HOOKS_OUT", repr(str(out))))
    monkeypatch.chdir(tmp_path)
    args = [str(script)] + (["--tier-base", str(tmp_path / "tiers")] if cli == "compare"
                            else [])
    importlib.import_module(f"repro_torch.{cli}").main(args)
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert rows and all(r["repro"] == [False, False, False] for r in rows)
    assert rows[0]["repro_torch"] == want
    assert (tcap.FORCE, tobs.FORCE, tobs.FORCE_BACKEND) == (False, False, None)
    assert (rcap.FORCE, robs.FORCE, robs.FORCE_BACKEND) == (False, False, None)
