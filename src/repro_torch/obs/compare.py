"""Sim-vs-real validation: align two runs of the same DAG and report how
far the simulator's congestion model is from measured reality.

The harness (``python -m repro.compare <script>`` or
``benchmarks/sim_vs_real.py``) runs the same task graph once under
``SimBackend`` (predicted durations from the modelled
:class:`StorageDevice` parameters) and once under
``RealBackend(tier_dirs=)`` (measured wall times + TelemetryHub
samples). This module pairs the two completed-task populations, computes
the per-task / per-signature / per-tier / per-device model error, and —
together with :func:`repro.obs.telemetry.fit_tiers` — produces the
calibration report (fitted vs configured bandwidth per tier) that a
``--fit`` re-run feeds back into the simulator.

Alignment: task ids are assigned in submission order, so for an
identical DAG the Nth submitted task of a signature in the sim run *is*
the Nth submitted task of that signature in the real run — pairing is by
``(signature, per-signature submission rank)``, robust to the two
backends finishing work in different orders.
"""
from __future__ import annotations

from typing import Optional

from .telemetry import fit_tiers


def measured_duration(task) -> float:
    """The duration a real task actually took: the final successful
    attempt's wall time when the backend measured it, else end - start."""
    if task.measured_duration is not None:
        return task.measured_duration
    return task.duration


def _by_signature(rt) -> dict:
    groups: dict[str, list] = {}
    for t in sorted(rt.scheduler.completed, key=lambda t: t.tid):
        groups.setdefault(t.defn.signature, []).append(t)
    return groups


def align_tasks(sim_rt, real_rt) -> list:
    """``(sim_task, real_task)`` pairs by (signature, submission rank)."""
    sim_g, real_g = _by_signature(sim_rt), _by_signature(real_rt)
    pairs = []
    for sig in sim_g:
        pairs.extend(zip(sim_g[sig], real_g.get(sig, [])))
    return pairs


def _median(vals: list) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def duration_error_report(sim_rt, real_rt, min_wall_s: float = 1e-6) -> dict:
    """Per-task model error (predicted vs measured duration) with
    per-signature / per-tier / per-device aggregates.

    ``rel_err = (predicted - measured) / measured`` — positive means the
    model over-estimates (sim slower than reality). The headline
    ``median_abs_rel_error`` covers I/O tasks placed on a device (the
    population the congestion model actually predicts);
    ``median_abs_rel_error_all`` includes compute tasks too."""
    rows = []
    for s, r in align_tasks(sim_rt, real_rt):
        meas = measured_duration(r)
        if meas < min_wall_s:
            meas = min_wall_s
        pred = s.duration
        rel = (pred - meas) / meas
        rows.append({
            "sig": s.defn.signature,
            "tid_sim": s.tid,
            "tid_real": r.tid,
            "predicted_s": pred,
            "measured_s": meas,
            "rel_err": rel,
            "abs_rel_err": abs(rel),
            "is_io": s.is_io,
            "device": s.device.name if s.device is not None else None,
            "tier": s.device.tier if s.device is not None else None,
        })

    def agg(key) -> dict:
        out: dict = {}
        for row in rows:
            k = row[key]
            if k is None:
                continue
            out.setdefault(k, []).append(row["abs_rel_err"])
        return {k: {"n": len(v), "median_abs_rel_err": _median(v)}
                for k, v in sorted(out.items())}

    io_errs = [r["abs_rel_err"] for r in rows
               if r["is_io"] and r["device"] is not None]
    return {
        "n_pairs": len(rows),
        "n_io_pairs": len(io_errs),
        "tasks": rows,
        "by_signature": agg("sig"),
        "by_tier": agg("tier"),
        "by_device": agg("device"),
        "median_abs_rel_error": _median(io_errs),
        "median_abs_rel_error_all": _median(
            [r["abs_rel_err"] for r in rows]),
    }


def tier_fit_report(real_rt, sim_cluster) -> dict:
    """Fitted-vs-configured congestion parameters per tier: what the real
    run measured (TelemetryHub fit) against what the sim cluster's
    :class:`StorageDevice` objects assume."""
    hub = getattr(real_rt.backend, "telemetry", None)
    fitted = fit_tiers(hub) if hub is not None else {}
    configured: dict = {}
    for dev in sim_cluster.devices:
        cfg = configured.setdefault(dev.tier, {
            "bandwidth": dev.bandwidth,
            "per_stream_cap": dev.per_stream_cap,
            "congestion_alpha": dev.congestion_alpha,
        })
        # several devices per tier share the spec by construction; keep
        # the first seen
        del cfg
    out = {}
    for tier in sorted(set(fitted) | set(configured)):
        f, c = fitted.get(tier), configured.get(tier)
        entry: dict = {"fitted": f, "configured": c}
        if f and c and c["bandwidth"] > 0:
            entry["bandwidth_ratio"] = f["bandwidth"] / c["bandwidth"]
        out[tier] = entry
    return out


def format_report(rep: dict, fit: Optional[dict] = None) -> str:
    """Human-readable rendering of a duration-error report (+ optional
    tier-fit report) for the CLI."""
    lines = []
    med = rep["median_abs_rel_error"]
    lines.append(
        f"paired tasks: {rep['n_pairs']} ({rep['n_io_pairs']} I/O)")
    lines.append(
        "median |rel err|: "
        + (f"{med:.3g}" if med is not None else "n/a (no I/O pairs)")
        + f" (all tasks: {rep['median_abs_rel_error_all']:.3g})")
    if rep["by_tier"]:
        lines.append("per tier:")
        for tier, a in rep["by_tier"].items():
            lines.append(f"  {tier:<6} n={a['n']:<4} "
                         f"median |rel err|={a['median_abs_rel_err']:.3g}")
    if fit:
        lines.append("fitted vs configured (per tier):")
        for tier, entry in fit.items():
            f, c = entry.get("fitted"), entry.get("configured")
            if f and c:
                lines.append(
                    f"  {tier:<6} bandwidth {f['bandwidth']:.1f} MB/s "
                    f"(configured {c['bandwidth']:.1f}), per-stream "
                    f"{f['per_stream_cap']:.1f} "
                    f"(configured {c['per_stream_cap']:.1f}), "
                    f"alpha {f['congestion_alpha']:.4f}")
            elif c:
                lines.append(f"  {tier:<6} no measured samples "
                             f"(configured {c['bandwidth']:.1f} MB/s)")
    return "\n".join(lines)
