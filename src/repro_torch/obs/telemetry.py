"""Measured per-device I/O telemetry for the RealBackend.

The simulator *models* device throughput; outside it the runtime was
flying blind — nothing measured what the storage actually delivered.
:class:`TelemetryHub` closes that gap: the ``RealBackend`` feeds it on
every I/O launch/complete (bytes moved, measured wall time of the final
attempt, in-flight concurrency) and it maintains, per device:

- sliding-window measured throughput (MB/s over the last ``window_s``),
- the effective per-stream rate of each completed op (``mb / wall_s``),
- the current queue depth (in-flight op count),
- lifetime totals (ops, MB, wall seconds, peak windowed MB/s).

Every successful sample is also emitted as a frozen-schema ``telemetry``
event through the bound :class:`TraceRecorder` (when the run is traced),
rolled into ``rt.stats()["telemetry"]`` and exported as Perfetto counter
tracks. The hub is real-backend-only: ``SimBackend`` never touches it,
so sim traces and launch logs stay byte-identical.

:func:`fit_tiers` turns the collected samples into a calibration — a
per-tier ``{bandwidth, per_stream_cap, congestion_alpha}`` estimate of
the measured congestion curve — and :func:`apply_tier_config` feeds it
back into a cluster's :class:`StorageDevice` parameters, which is what
``python -m repro.compare --fit`` and ``benchmarks/sim_vs_real.py`` use
to shrink the sim-vs-real model error.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional


class DeviceTelemetry:
    """Measured state of one device (identified by name)."""

    __slots__ = ("name", "tier", "inflight", "n_ops", "n_failed",
                 "total_mb", "total_wall_s", "peak_mbps", "last_t",
                 "samples")

    def __init__(self, name: str, tier: Optional[str], max_samples: int):
        self.name = name
        self.tier = tier
        self.inflight = 0            # ops launched, not yet completed
        self.n_ops = 0               # successful completions
        self.n_failed = 0
        self.total_mb = 0.0
        self.total_wall_s = 0.0
        self.peak_mbps = 0.0         # max windowed throughput seen
        self.last_t = 0.0
        # (t_end, mb, wall_s, k) per successful op; k = concurrency the op
        # ran under (max of launch-time and completion-time in-flight)
        self.samples: deque = deque(maxlen=max_samples)


class TelemetryHub:
    """Per-device measured-throughput aggregator (RealBackend-fed).

    Call sites hold the runtime lock already (``launch`` and the
    completion block both run under it), but the hub keeps its own small
    lock so it is safe to read from any thread (``summary()`` during a
    live run, the fit harness after it).
    """

    def __init__(self, window_s: float = 5.0, max_samples: int = 4096):
        self.window_s = float(window_s)
        self.max_samples = int(max_samples)
        self.recorder = None         # TraceRecorder, bound by the backend
        self._lock = threading.Lock()
        self.devices: dict[str, DeviceTelemetry] = {}

    def bind(self, recorder) -> None:
        self.recorder = recorder

    def _dev(self, device) -> DeviceTelemetry:
        d = self.devices.get(device.name)
        if d is None:
            d = self.devices[device.name] = DeviceTelemetry(
                device.name, getattr(device, "tier", None), self.max_samples)
        return d

    # ------------------------------------------------------------- feeding
    def on_launch(self, t: float, device) -> int:
        """An I/O op was launched on ``device`` at backend time ``t``.
        Returns the in-flight count including this op (the launch-side
        concurrency snapshot the backend stashes on the task)."""
        with self._lock:
            d = self._dev(device)
            d.inflight += 1
            return d.inflight

    def on_complete(self, t: float, device, mb: float,
                    wall_s: Optional[float], *, failed: bool = False,
                    launch_inflight: int = 0) -> None:
        """An I/O op completed at backend time ``t`` having moved ``mb``
        MB in ``wall_s`` measured seconds. Failed ops (and ops with no
        measured wall time) still decrement the queue depth but record no
        throughput sample."""
        rec = self.recorder
        ev = None
        with self._lock:
            d = self._dev(device)
            k = max(d.inflight, 1)          # completion-side concurrency
            d.inflight = max(d.inflight - 1, 0)
            if failed:
                d.n_failed += 1
                return
            if wall_s is None or wall_s <= 0.0:
                return
            k = max(k, int(launch_inflight))
            mb = float(mb)
            wall_s = float(wall_s)
            d.n_ops += 1
            d.total_mb += mb
            d.total_wall_s += wall_s
            d.last_t = t
            d.samples.append((float(t), mb, wall_s, k))
            mbps = self._windowed_mbps(d, t)
            d.peak_mbps = max(d.peak_mbps, mbps)
            if rec is not None:
                ev = dict(t=float(t), device=d.name, tier=d.tier,
                          mbps=mbps, stream_mbps=mb / wall_s,
                          inflight=d.inflight, mb=mb, wall_s=wall_s)
        if ev is not None:
            rec.on_telemetry(**ev)

    # ------------------------------------------------------------- reading
    def _window(self, d: DeviceTelemetry, t: float) -> list:
        lo = t - self.window_s
        return [s for s in d.samples if s[0] >= lo]

    def _windowed_mbps(self, d: DeviceTelemetry, t: float) -> float:
        """Aggregate measured throughput over the sliding window ending at
        ``t``: MB completed in the window divided by the span the window's
        ops actually covered (from the earliest op *start* in the window,
        clipped to ``window_s``) — so early samples aren't diluted by the
        part of the window before any I/O ran."""
        win = self._window(d, t)
        if not win:
            return 0.0
        start = min(s[0] - s[2] for s in win)
        span = min(self.window_s, max(t - start, 1e-9))
        return sum(s[1] for s in win) / span

    def summary(self) -> dict:
        """Per-device rollup for ``rt.stats()["telemetry"]``."""
        out: dict = {"window_s": self.window_s, "devices": {}}
        with self._lock:
            for name in sorted(self.devices):
                d = self.devices[name]
                win = self._window(d, d.last_t)
                stream = (sum(s[1] / s[2] for s in win) / len(win)
                          if win else 0.0)
                out["devices"][name] = {
                    "tier": d.tier,
                    "n_ops": d.n_ops,
                    "n_failed": d.n_failed,
                    "inflight": d.inflight,
                    "total_mb": d.total_mb,
                    "mbps": self._windowed_mbps(d, d.last_t),
                    "peak_mbps": d.peak_mbps,
                    "stream_mbps": stream,
                    "last_t": d.last_t,
                    "n_samples": len(d.samples),
                }
        return out

    def snapshot_samples(self) -> dict:
        """``{device_name: [(t, mb, wall_s, k), ...]}`` copy for fitting."""
        with self._lock:
            return {name: list(d.samples)
                    for name, d in self.devices.items()}


# --------------------------------------------------------------------------
# Fitting measured samples back into StorageDevice parameters
# --------------------------------------------------------------------------
def fit_samples(samples: list) -> Optional[dict]:
    """Fit ``{bandwidth, per_stream_cap, congestion_alpha}`` from a list of
    ``(t, mb, wall_s, k)`` samples of one device. Deterministic; returns
    None when no sample moved any data (latency-only ops can't constrain a
    bandwidth model)."""
    by_k: dict[int, list[float]] = {}
    for _, mb, wall_s, k in samples:
        if mb > 0.0 and wall_s > 0.0:
            by_k.setdefault(max(int(k), 1), []).append(mb / wall_s)
    if not by_k:
        return None
    mean_rate = {k: sum(v) / len(v) for k, v in by_k.items()}
    k_min = min(mean_rate)
    # single stream (or the least-contended concurrency observed) sets the
    # per-stream cap; aggregate throughput A(k) ~= k * mean_rate(k) peaks
    # at the measured bandwidth ceiling
    per_stream = mean_rate[k_min]
    bandwidth = max(k * r for k, r in mean_rate.items())
    bandwidth = max(bandwidth, per_stream)
    # congestion ramp: past the knee the model divides A(k) by
    # (1 + alpha*over) (the quadratic term is negligible at these depths);
    # estimate alpha from the aggregate decline at the deepest measured k
    knee = max(1, int(bandwidth / per_stream)) if per_stream > 0 else 1
    alpha = 0.0
    deep = [(k, k * r) for k, r in mean_rate.items() if k > knee]
    if deep:
        k_deep, a_deep = max(deep)
        over = k_deep - knee
        if a_deep > 0 and over > 0 and bandwidth > a_deep:
            alpha = min(max((bandwidth / a_deep - 1.0) / over, 0.0), 1.0)
    return {"bandwidth": bandwidth, "per_stream_cap": per_stream,
            "congestion_alpha": alpha,
            "n_samples": sum(len(v) for v in by_k.values()),
            "max_k": max(by_k)}


def fit_tiers(hub: TelemetryHub) -> dict:
    """Per-tier calibration from a hub's measured samples: device fits
    grouped by tier label, averaged when a tier has several devices."""
    per_tier: dict[str, list[dict]] = {}
    snap = hub.snapshot_samples()
    with hub._lock:
        tiers = {name: d.tier for name, d in hub.devices.items()}
    for name in sorted(snap):
        fit = fit_samples(snap[name])
        if fit is not None:
            per_tier.setdefault(tiers.get(name) or "default", []).append(fit)
    out = {}
    for tier, fits in sorted(per_tier.items()):
        n = len(fits)
        out[tier] = {
            "bandwidth": sum(f["bandwidth"] for f in fits) / n,
            "per_stream_cap": sum(f["per_stream_cap"] for f in fits) / n,
            "congestion_alpha": sum(f["congestion_alpha"] for f in fits) / n,
            "n_samples": sum(f["n_samples"] for f in fits),
            "max_k": max(f["max_k"] for f in fits),
        }
    return out


def apply_tier_config(cluster, tier_config: dict) -> int:
    """Overwrite the congestion-model parameters of every device whose tier
    appears in ``tier_config`` (a :func:`fit_tiers`-shaped dict). Returns
    the number of devices updated. Only meaningful before a run starts —
    the dynamic state (available_bw) is reset to the new ceiling."""
    n = 0
    for dev in cluster.devices:
        cfg = tier_config.get(dev.tier)
        if cfg is None:
            continue
        dev.bandwidth = float(cfg["bandwidth"])
        dev.per_stream_cap = float(cfg["per_stream_cap"])
        if "congestion_alpha" in cfg:
            dev.congestion_alpha = float(cfg["congestion_alpha"])
        dev.congestion_knee = max(1, int(dev.bandwidth / dev.per_stream_cap))
        dev.available_bw = dev.bandwidth
        dev.invalidate_rates()  # memoized T(k) curve is stale (storage_model)
        n += 1
    return n
