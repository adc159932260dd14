"""One run of one cell: find it and its files by the names in
``BENCHMARK.json``, hand it to its traffic's driver, read its metrics,
decide ``correct`` and print the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by name:
``bench/configs/<config>.json`` (sizes, source, limits of the checks),
``bench/models/<model_type>.py`` (weights from the seed, the port's config,
the plain reference), ``bench/traffic/<traffic>.json`` (whose ``driver``
names ``bench/drivers/<driver>.py``) and ``bench/metrics/<metric>.py``
(``read(run)``, which returns a number or None).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

from .trace import Spans

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
#: top-level module names that may not be loaded in a run: JAX, its
#: relatives and the JAX package this port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started (Linux: from /proc; elsewhere 0)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat[stat.rindex(")") + 2:].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str, bench: dict | None = None):
    """(cell entry, config file, traffic file) of workload ``name``."""
    bench = bench or manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, load_json(ROOT / conf["file"]), load_json(BENCH / "traffic" /
                                                           f"{cell['traffic']}.json")


def model_module(c: dict):
    return importlib.import_module(f"bench.models.{c['model_type']}")


def driver_module(tr: dict):
    return importlib.import_module(f"bench.drivers.{tr['driver']}")


def metric_reader(name: str):
    """``read`` of ``bench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Run:
    """The state of one run, handed to the driver and to the readers.

    Set by the harness: ``cell`` (its name), ``c`` (config file), ``tr``
    (traffic file), ``seed``, ``seconds``, ``traced``, ``device``, ``spans``.
    Set by the driver: ``e2e`` {metric: value}, ``readings`` {check: value},
    ``attempted``, ``failed``, ``memory_peak_bytes``, ``trace`` (the traced
    region's ``DeviceTrace``, or None), ``counters`` {name: value} of what
    the program counted, and ``window_start`` (``time.perf_counter``)."""

    def __init__(self, cell, c, tr, seed, seconds, traced, device="cuda"):
        self.cell, self.c, self.tr = cell, c, tr
        self.seed, self.seconds, self.traced, self.device = seed, seconds, traced, device
        self.spans = Spans()
        self.e2e: dict = {}
        self.readings: dict = {}
        self.counters: dict = {}
        self.attempted = self.failed = 0
        self.memory_peak_bytes = 0
        self.trace = None
        self.window_start = None
        self.process_start = time.perf_counter() - process_age_s()


def execute(run: Run) -> Run:
    driver_module(run.tr).run(run)
    return run


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {check: {"value", "limit"}}): every reading is a number at or
    under its limit, and every limit was read."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name)
        checks[name] = {"value": v, "limit": limit}
        if v is None or not math.isfinite(v) or v > limit:
            ok = False
    return ok, checks


def result(run: Run, bench: dict) -> tuple[dict, list[str]]:
    """The result line and the stderr lines of the checks."""
    import torch
    metrics = {}
    if run.traced:
        for m in bench["per_layer"]:
            if applies(m, run.cell):
                v = metric_reader(m["name"])(run)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, run.cell) and m["name"] in run.e2e:
                metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
    limits = {k: v for k, v in run.c["limits"].items() if k in run.readings}
    correct, checks = judge(run.readings, limits)
    correct = correct and run.attempted > 0 and run.failed == 0 and bool(limits)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if run.traced and run.trace is not None:
        device["busy_s"], device["window_s"] = run.trace.busy_s, run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    return out, lines


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = manifest()
    cell, c, tr = cell_files(args.workload, bench)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench: the cell needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(args.workload, c, tr, args.seed, args.seconds, bool(args.trace))
    execute(run)
    bad = forbidden_modules()
    if bad:
        print(f"bench: modules that may not be loaded were loaded: {bad}", file=sys.stderr)
        return 4
    out, lines = result(run, bench)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def now() -> float:
    return time.perf_counter()


def log(run: Run, msg: str) -> None:
    """A progress line on stderr, with the seconds since the process began."""
    print(f"[bench +{now() - run.process_start:.1f}s] {msg}", file=sys.stderr, flush=True)
