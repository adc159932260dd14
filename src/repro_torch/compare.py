"""``python -m repro_torch.compare <script.py>`` — sim-vs-real validation CLI.

Mirror of ``repro.compare`` (same arguments, output and exit codes) for
scripts written against ``repro_torch``: it sets ``repro_torch.obs.FORCE``
and ``FORCE_BACKEND``, which the port's runtimes read, and no hook of
the JAX package.

Runs the script's DAG twice with forced tracing (the ``repro_torch.trace``
hijack) plus *forced backend substitution* (``obs.FORCE_BACKEND``):

1. **predicted leg** — every ``IORuntime`` the script constructs runs
   under a fresh ``SimBackend`` (a script that already asked for the
   simulator keeps its own backend, sanitizer flags and all);
2. **measured leg** — the same runtimes run under
   ``RealBackend(tier_dirs=)`` pointed at per-tier temp directories
   (``--tier-base``), executing the task bodies for real and collecting
   TelemetryHub throughput samples.

The two completed-task populations are aligned by (signature, submission
rank) and the per-task / per-tier / per-device model error is reported
(``repro_torch.obs.compare``), together with the fitted-vs-configured
bandwidth per tier. ``--fit OUT.json`` additionally writes the fitted
tier config and re-runs the predicted leg with it applied — the
calibrated error is reported next to the default one (the sim_vs_real
benchmark asserts it shrinks).

Exit status: 0 on success, 2 on harness errors (missing file, script
crash, no runtime constructed, leg mismatch).
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import tempfile

from . import obs
from .obs import compare as obs_compare
from .obs import perfetto
from .obs.telemetry import apply_tier_config, fit_tiers


def _reset_ids() -> None:
    """Fresh id spaces per leg so submission-rank alignment is exact even
    for scripts that rely on tids (e.g. in file names)."""
    from .core.datalife import DataObject
    from .core.task import DataHandle, TaskInstance
    TaskInstance._ids = itertools.count()
    DataHandle._ids = itertools.count()
    DataObject._ids = itertools.count()


def _sim_factory(tier_config=None):
    def factory(cluster, requested):
        from .core.backends import SimBackend
        if tier_config:
            apply_tier_config(cluster, tier_config)
        if isinstance(requested, SimBackend) and not tier_config:
            return None  # keep the script's own simulator (sanitize= etc.)
        return SimBackend()
    return factory


def _real_factory(tier_base: str):
    def factory(cluster, requested):
        from .core.backends import RealBackend
        if isinstance(requested, RealBackend):
            return None  # the script already runs for real; keep its dirs
        tier_dirs = {}
        for tier in cluster.tier_names():
            d = os.path.join(tier_base, tier)
            os.makedirs(d, exist_ok=True)
            tier_dirs[tier] = d
        return RealBackend(tier_dirs=tier_dirs)
    return factory


def _run_leg(path: str, factory) -> tuple[list, list[str]]:
    """Execute ``path`` once with forced tracing + backend substitution."""
    import runpy

    _reset_ids()
    obs.RUNS.clear()
    obs.FORCE = True
    obs.FORCE_BACKEND = factory
    notes: list[str] = []
    old_argv = sys.argv
    sys.argv = [path]
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            notes.append(f"{path}: exited with status {e.code}")
    except BaseException as e:  # noqa: BLE001 — report what ran anyway
        notes.append(f"{path}: raised {type(e).__name__} ({e})")
    finally:
        sys.argv = old_argv
        obs.FORCE = False
        obs.FORCE_BACKEND = None
    runs = list(obs.RUNS)
    obs.RUNS.clear()
    return runs, notes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.compare",
        description="Run a script once under SimBackend and once under "
                    "RealBackend(tier_dirs=) and report the sim-vs-real "
                    "model error (see docs/observability.md).")
    parser.add_argument("script", metavar="script.py",
                        help="Python script to run under both backends")
    parser.add_argument("--tier-base", metavar="DIR",
                        help="base directory for per-tier real I/O "
                             "(default: a fresh temp directory)")
    parser.add_argument("--fit", metavar="OUT.json",
                        help="write the fitted tier config and re-run the "
                             "predicted leg with it applied")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable report (one JSON doc)")
    parser.add_argument("--perfetto", metavar="OUT.json",
                        help="export the measured leg's Chrome trace-event "
                             "JSON (per runtime; -1, -2, ... suffixes)")
    args = parser.parse_args(argv)

    path = args.script
    if not os.path.isfile(path):
        print(f"repro_torch.compare: no such file: {path}", file=sys.stderr)
        return 2
    tier_base = args.tier_base or tempfile.mkdtemp(prefix="repro_compare_")

    status = 0
    sim_runs, notes = _run_leg(path, _sim_factory())
    real_runs, real_notes = _run_leg(path, _real_factory(tier_base))
    for note in notes + real_notes:
        print(f"note: {note}", file=sys.stderr)
        status = 2
    if not sim_runs or not real_runs:
        print(f"repro_torch.compare: {path}: no IORuntime constructed — "
              f"nothing to compare", file=sys.stderr)
        return 2
    if len(sim_runs) != len(real_runs):
        print(f"repro_torch.compare: {path}: leg mismatch — {len(sim_runs)} "
              f"sim runtime(s) vs {len(real_runs)} real; the script must "
              f"construct the same runtimes under both backends",
              file=sys.stderr)
        return 2

    fitted_cfg = None
    fitted_runs: list = []
    if args.fit:
        # fit from every measured runtime's hub, merged (later runtimes
        # win ties — same tier labels measure the same directories)
        fitted_cfg = {}
        for _, rt in real_runs:
            hub = getattr(rt.backend, "telemetry", None)
            if hub is not None:
                fitted_cfg.update(fit_tiers(hub))
        with open(args.fit, "w") as f:
            json.dump({"script": path, "tiers": fitted_cfg}, f, indent=2,
                      sort_keys=True)
        print(f"fitted tier config written: {args.fit}", file=sys.stderr)
        if fitted_cfg:
            fitted_runs, fit_notes = _run_leg(
                path, _sim_factory(tier_config=fitted_cfg))
            for note in fit_notes:
                print(f"note: {note}", file=sys.stderr)
                status = 2

    doc = []
    for i, ((label, sim_rt), (_, real_rt)) in enumerate(
            zip(sim_runs, real_runs), start=1):
        rep = obs_compare.duration_error_report(sim_rt, real_rt)
        fit_rep = obs_compare.tier_fit_report(real_rt, sim_rt.cluster)
        entry = {"script": path, "runtime": label, "report": rep,
                 "tier_fit": fit_rep}
        if fitted_runs and i <= len(fitted_runs):
            frep = obs_compare.duration_error_report(
                fitted_runs[i - 1][1], real_rt)
            entry["report_fitted"] = frep
        if args.as_json:
            slim = dict(entry)
            slim["report"] = {k: v for k, v in rep.items() if k != "tasks"}
            if "report_fitted" in entry:
                slim["report_fitted"] = {
                    k: v for k, v in entry["report_fitted"].items()
                    if k != "tasks"}
            doc.append(slim)
        else:
            print(f"== {path} {label} ==")
            print(obs_compare.format_report(rep, fit_rep))
            if "report_fitted" in entry:
                fmed = entry["report_fitted"]["median_abs_rel_error"]
                dmed = rep["median_abs_rel_error"]
                print("calibrated median |rel err|: "
                      + (f"{fmed:.3g}" if fmed is not None else "n/a")
                      + (f" (default {dmed:.3g})"
                         if dmed is not None else ""))
            print()
        if args.perfetto:
            rec = real_rt.recorder
            if rec is not None:
                root, ext = os.path.splitext(args.perfetto)
                out = args.perfetto if len(real_runs) == 1 \
                    else f"{root}-{i}{ext or '.json'}"
                with open(out, "w") as f:
                    f.write(perfetto.dumps(rec))
                print(f"perfetto trace written: {out}", file=sys.stderr)
    if args.as_json:
        print(json.dumps(doc, indent=2, sort_keys=True))
    return status


if __name__ == "__main__":
    raise SystemExit(main())
