"""``python -m repro_torch.lint <script.py> ...`` — static I/O-plan analyzer CLI.

Mirror of ``repro.lint`` (same arguments, output and exit codes) for
scripts written against ``repro_torch``: it forces capture through
``repro_torch.analysis.capture``, which the port's runtimes read, and
sets no hook of the JAX package.

Runs each script under *forced capture*: every ``IORuntime`` the script
constructs is hijacked into capture mode (the backend it asked for is
replaced by :class:`repro_torch.analysis.CaptureBackend`), so the full task DAG
is recorded but **no task body executes**. The recorded plans are then run
through the lint rule engine (repro_torch.analysis.lint; catalog in
docs/lint.md).

Exit status: 0 when every script is clean, 1 when any diagnostic was
emitted, 2 on harness errors (missing file). Script exceptions *after*
the DAG was captured are reported as notes, not failures — under capture
every future resolves to ``None``, so result post-processing in a script
may legitimately fail.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .analysis.lint import lint_script


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="Static I/O-plan analyzer: capture each script's task "
                    "DAG without executing it and report IO1xx-IO4xx "
                    "diagnostics (see docs/lint.md).")
    parser.add_argument("scripts", nargs="+", metavar="script.py",
                        help="Python scripts to capture and lint")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable output (one JSON document)")
    args = parser.parse_args(argv)

    results = []
    status = 0
    for path in args.scripts:
        if not os.path.isfile(path):
            print(f"repro_torch.lint: no such file: {path}", file=sys.stderr)
            return 2
        diags, notes = lint_script(path)
        results.append((path, diags, notes))
        if diags:
            status = 1

    if args.as_json:
        doc = [{"script": path,
                "diagnostics": [{"code": d.code, "category": d.category,
                                 "task": d.task, "tid": d.tid,
                                 "message": d.message} for d in diags],
                "notes": notes}
               for path, diags, notes in results]
        print(json.dumps(doc, indent=2))
        return status

    total = 0
    for path, diags, notes in results:
        for note in notes:
            print(f"note: {note}", file=sys.stderr)
        for d in diags:
            print(f"{path}: {d}")
        total += len(diags)
        if not diags:
            print(f"{path}: clean")
    if total:
        print(f"{total} diagnostic(s) across {len(results)} script(s)",
              file=sys.stderr)
    return status


if __name__ == "__main__":
    raise SystemExit(main())
