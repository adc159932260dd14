"""The port's examples (``examples/torch/``) against the JAX package's
(``examples/``): each twin runs with ``--device cpu`` in a process of its
own, exits 0 and prints what its JAX example prints, in structure (the
same lines with the numbers and temporary paths left out, so the same
counts, listings and ``resume OK``). The quickstart's simulation runs on
byte-identical runtimes, so its lines are equal, numbers included. The
JAX dry-run example fails under jax 0.9 on its own ``Explicit`` mesh (a
quirk of the reference): the twin's record is held to the keys the JAX
example prints, with ``status: ok``. Every process runs at once."""
import ast
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["quickstart", "serve_batched", "train_with_io_aware_checkpointing",
            "dryrun_one_cell", "burst_buffer_checkpoint", "measure_real_tiers"]
TIMEOUT = 600
# a number (with its sign and exponent), a temporary directory
_NUMBER = re.compile(r"[-+]?\d+(\.\d+)?(e[-+]?\d+)?")
_TMP = re.compile(r"/\S*tmp\S*")


def structure(text: str) -> list[str]:
    """Each line with its numbers, temporary paths and the padding of its
    columns (which follows the numbers' widths) left out."""
    return [" ".join(_NUMBER.sub("<n>", _TMP.sub("<tmp>", line)).split())
            for line in text.splitlines() if line.strip()]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """``{(package, example): (exit code, stdout)}``; each process with its
    own working directory and temporary directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.setdefault("JAX_PLATFORMS", "cpu")
    base = tmp_path_factory.mktemp("examples")
    procs = {}
    for pkg, ex in [("torch", e) for e in EXAMPLES] + [
            ("jax", e) for e in EXAMPLES if e != "dryrun_one_cell"]:
        tmp = base / f"{pkg}_{ex}"
        tmp.mkdir()
        script = ROOT / "examples" / ("torch" if pkg == "torch" else "") / f"{ex}.py"
        args = [sys.executable, str(script)] + (["--device", "cpu"] if pkg == "torch" else [])
        if (pkg, ex) == ("torch", "dryrun_one_cell"):
            args.append("--force")          # not a record of an earlier run
        procs[pkg, ex] = subprocess.Popen(args, cwd=ROOT, env={**env, "TMPDIR": str(tmp)},
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True)
    deadline = time.monotonic() + TIMEOUT
    out = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=max(deadline - time.monotonic(), 1))
            out[key] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("example", EXAMPLES)
def test_twin_runs_on_the_cpu(outputs, example):
    rc, stdout, stderr = outputs["torch", example]
    assert rc == 0, stderr[-4000:]
    assert stdout.strip()


@pytest.mark.parametrize("example", [e for e in EXAMPLES if e != "dryrun_one_cell"])
def test_twin_prints_what_the_jax_example_prints(outputs, example):
    got, want = outputs["torch", example], outputs["jax", example]
    assert want[0] == 0, want[2][-4000:]
    if example == "quickstart":
        assert got[1] == want[1]
    else:
        assert structure(got[1]) == structure(want[1])


def test_dryrun_twin_prints_the_ports_record(outputs):
    lines = outputs["torch", "dryrun_one_cell"][1].splitlines()
    head, rec = ast.literal_eval(lines[0]), ast.literal_eval(lines[1])
    assert head == {"arch": "tinyllama-1.1b", "shape": "train_4k", "status": "ok"}
    assert rec["n_devices"] == 256 and rec["flops"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
