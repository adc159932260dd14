"""Human- and benchmark-facing rollups over a :class:`TraceRecorder`.

``attribution(recorder)`` is what benchmarks embed in their BENCH JSON
envelopes; ``format_summary`` renders the ``python -m repro.trace`` table;
``percentile`` is the shared quantile helper the serve loop uses for
p50/p99 over recorded request spans.
"""
from __future__ import annotations

from .recorder import WAIT_STATES


def percentile(values, q: float) -> float:
    """Linear-interpolation quantile (q in [0, 1]) without numpy, so the
    core stays dependency-free. Empty input -> 0.0."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return 0.0
    if len(vals) == 1:
        return vals[0]
    pos = q * (len(vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


def attribution(recorder, graph=None) -> dict:
    """The trace attribution summary benchmarks attach to BENCH JSONs:
    wait-state rollup plus (when the task graph is supplied) the
    critical-path congestion report."""
    out = {"wait_states": recorder.wait_state_summary()}
    if graph is not None:
        out["critical_path"] = recorder.critical_path_report(graph)
    return out


def span_latencies(recorder, cat: str = "request") -> list[float]:
    """Durations (seconds) of recorded spans in category ``cat``."""
    return [ev["dur"] for ev in recorder.events
            if ev["type"] == "span" and ev["cat"] == cat]


def format_summary(recorder, label: str = "") -> str:
    """Fixed-width summary table: event counts, sampled devices, and the
    wait-state rollup with its residual."""
    s = recorder.summary()
    ws = s["wait_states"]
    lines = []
    title = f"trace summary{': ' + label if label else ''}"
    lines.append(title)
    lines.append("=" * len(title))
    lines.append(f"{'events':<24}{s['n_events']}")
    for name in sorted(s["events_by_type"]):
        lines.append(f"  {name:<22}{s['events_by_type'][name]}")
    lines.append(f"{'devices sampled':<24}{s['n_devices_sampled']}")
    lines.append(f"{'finished tasks':<24}{ws['n_tasks']}")
    total = ws["total_latency"]
    lines.append(f"{'total task latency':<24}{total:.3f} s")
    if ws["n_tasks"]:
        lines.append("wait-state attribution")
        for k in WAIT_STATES:
            v = ws["states"][k]
            if v <= 0:
                continue
            pct = 100.0 * v / total if total > 0 else 0.0
            lines.append(f"  {k:<22}{v:>10.3f} s  {pct:5.1f}%")
        lines.append(f"  {'residual':<22}{ws['residual']:>10.3f} s")
        lines.append(f"  {'min task coverage':<22}"
                     f"{100.0 * ws['min_task_coverage']:>9.2f}%")
    return "\n".join(lines)
