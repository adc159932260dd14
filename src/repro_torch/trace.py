"""``python -m repro_torch.trace <script.py> ...`` — observability CLI.

Mirror of ``repro.trace`` (same arguments, output and exit codes) for
scripts written against ``repro_torch``: it sets ``repro_torch.obs.FORCE``,
which the port's runtimes read, and no hook of the JAX package.

Runs each script under *forced tracing*: every ``IORuntime`` the script
constructs gets a :class:`repro_torch.obs.TraceRecorder` wired into all event
sites (same hijack pattern as ``repro_torch.lint``'s forced capture — but the
script runs for real; tracing is pure reads, so behaviour is
bit-identical to an untraced run). For every traced runtime it prints a
summary table (event counts, wait-state attribution); ``--perfetto``
exports Chrome trace-event JSON loadable at https://ui.perfetto.dev,
``--jsonl`` dumps the raw typed event stream, ``--json`` emits one
machine-readable summary document.

Multiple runtimes in one script get ``-1``, ``-2``, ... suffixes on the
export paths. Exit status: 0 on success, 2 on harness errors (missing
file, script crash, no runtime constructed).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import obs
from .obs import perfetto
from .obs.report import format_summary


def _run_script(path: str) -> tuple[list, list[str]]:
    """Execute ``path`` with obs.FORCE on; returns (registered runs,
    notes)."""
    import runpy

    obs.RUNS.clear()
    obs.FORCE = True
    notes: list[str] = []
    old_argv = sys.argv
    sys.argv = [path]
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            notes.append(f"{path}: exited with status {e.code}")
    except BaseException as e:  # noqa: BLE001 — trace what ran anyway
        notes.append(f"{path}: raised {type(e).__name__} ({e})")
    finally:
        sys.argv = old_argv
        obs.FORCE = False
    runs = list(obs.RUNS)
    obs.RUNS.clear()
    return runs, notes


def _out_path(base: str, index: int, n_runs: int) -> str:
    if n_runs == 1:
        return base
    root, ext = os.path.splitext(base)
    return f"{root}-{index}{ext or '.json'}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.trace",
        description="Run scripts with I/O tracing forced on and report "
                    "event-stream summaries, wait-state attribution, and "
                    "Perfetto/JSONL exports (see docs/observability.md).")
    parser.add_argument("scripts", nargs="+", metavar="script.py",
                        help="Python scripts to run under forced tracing")
    parser.add_argument("--perfetto", metavar="OUT.json",
                        help="export Chrome trace-event JSON (per runtime; "
                             "multiple runtimes get -1, -2, ... suffixes)")
    parser.add_argument("--jsonl", metavar="OUT.jsonl",
                        help="dump the typed event stream as JSON lines")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable summaries (one JSON doc)")
    args = parser.parse_args(argv)

    status = 0
    doc = []
    for path in args.scripts:
        if not os.path.isfile(path):
            print(f"repro_torch.trace: no such file: {path}", file=sys.stderr)
            return 2
        runs, notes = _run_script(path)
        for note in notes:
            print(f"note: {note}", file=sys.stderr)
            status = 2
        if not runs:
            print(f"repro_torch.trace: {path}: no IORuntime constructed — "
                  f"nothing traced", file=sys.stderr)
            status = 2
            continue
        for i, (label, rt) in enumerate(runs, start=1):
            rec = rt.recorder
            if rec is None:
                continue
            tag = f"{path} {label}"
            if args.as_json:
                doc.append({"script": path, "runtime": label,
                            **rec.summary()})
            else:
                print(format_summary(rec, label=tag))
                print()
            if args.perfetto:
                out = _out_path(args.perfetto, i, len(runs))
                with open(out, "w") as f:
                    f.write(perfetto.dumps(rec))
                print(f"perfetto trace written: {out}", file=sys.stderr)
            if args.jsonl:
                out = _out_path(args.jsonl, i, len(runs))
                with open(out, "w") as f:
                    f.write(rec.to_jsonl() + "\n")
                print(f"event stream written: {out}", file=sys.stderr)
    if args.as_json:
        print(json.dumps(doc, indent=2))
    return status


if __name__ == "__main__":
    raise SystemExit(main())
