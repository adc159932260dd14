"""Unified I/O observability: event tracing, per-tier metrics timelines,
and wait-state attribution (docs/observability.md).

Enable per-runtime with ``IORuntime(cluster, trace=True)`` (or pass a
:class:`TraceConfig` / prebuilt :class:`TraceRecorder`), then read
``rt.trace()`` / ``rt.stats()["wait_states"]``. The ``python -m
repro.trace`` CLI instead sets :data:`FORCE`, which turns tracing on for
every runtime a script constructs and registers it here — the same
hijack pattern ``repro.lint`` uses for capture mode.
"""
from __future__ import annotations

from .recorder import (EVENT_SCHEMA, WAIT_STATES, MetricsTimeline,
                       TraceConfig, TraceRecorder)
from .telemetry import (TelemetryHub, apply_tier_config, fit_samples,
                        fit_tiers)
from . import compare, perfetto, report

#: When true, every IORuntime constructed enables tracing and registers
#: its recorder in RUNS (set only by the ``repro.trace`` CLI driver).
FORCE = False

#: ``(label, runtime)`` pairs registered while FORCE was on.
RUNS: list = []

#: Backend-substitution hook (set only by the ``repro.compare`` CLI
#: driver): a callable ``(cluster, requested_backend) -> Backend | None``
#: consulted by every IORuntime at construction. Returning a backend
#: swaps it in (the sim-vs-real harness runs the same unmodified script
#: once under SimBackend and once under RealBackend(tier_dirs=));
#: returning None keeps the script's own choice. Capture mode (the lint
#: hijack) always wins — a static analysis must never execute bodies.
FORCE_BACKEND = None


def register(runtime) -> None:
    RUNS.append((f"runtime-{len(RUNS) + 1}", runtime))


__all__ = [
    "EVENT_SCHEMA", "WAIT_STATES", "MetricsTimeline", "TraceConfig",
    "TraceRecorder", "TelemetryHub", "apply_tier_config", "fit_samples",
    "fit_tiers", "compare", "perfetto", "report", "FORCE", "RUNS",
    "FORCE_BACKEND", "register",
]
