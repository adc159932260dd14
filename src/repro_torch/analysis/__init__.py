"""Static I/O-plan analysis + inline runtime sanitizer (``iolint``).

Two halves, built on the runtime's own bookkeeping so diagnostics and
runtime behaviour can never disagree:

* **Static plan analyzer** (:mod:`.capture` + :mod:`.lint`):
  ``IORuntime(backend="capture")`` (or ``rt.plan()``) records the full task
  DAG *without executing any task body*, then :func:`~.lint.lint_runtime`
  runs a rule engine over the captured plan and emits structured
  :class:`~.lint.Diagnostic`\\ s with stable codes — ``IO1xx`` constraint
  satisfiability, ``IO2xx`` capacity/lifecycle, ``IO3xx`` races and
  ordering, ``IO4xx`` determinism. CLI: ``python -m repro.lint script.py``.

* **Inline sanitizer** (:mod:`.sanitizer`, "IOSan"):
  ``SimBackend(sanitize=True)`` asserts the property-test invariants at
  every simulation event boundary (occupancy ≤ capacity, bandwidth claims
  within budget, residency↔occupancy agreement, no scheduled reader on an
  evicted object, monotonic event time) and raises
  :class:`~.sanitizer.SanitizerError` at the *first* violation with the
  offending device/task and the recent event trace, instead of a corrupted
  end state at the barrier. The checks are read-only: sanitizer-on runs
  produce bit-identical launch logs.

See docs/lint.md for the full diagnostic catalog.
"""
from .capture import CaptureBackend, PlanCapture
from .lint import Diagnostic, lint_runtime, lint_script
from .sanitizer import IOSanitizer, SanitizerError

__all__ = [
    "CaptureBackend", "PlanCapture",
    "Diagnostic", "lint_runtime", "lint_script",
    "IOSanitizer", "SanitizerError",
]
