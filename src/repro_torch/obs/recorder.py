"""TraceRecorder: the unified observability event stream (docs/observability.md).

One recorder per :class:`~repro.core.runtime.IORuntime` (``trace=True``),
wired by the runtime into every existing event site: backend launch/
complete/retry and stuck-path steps, scheduler readiness + grant-refusal
diagnosis, datalife eviction/staging/pin lifecycle, interference burst
boundaries, failure-engine health transitions, and checkpoint
save/restore. It produces:

* a typed append-only **event stream** (:data:`EVENT_SCHEMA` is frozen —
  fields may be added under new event types, never removed or retyped);
* a per-device **metrics timeline** (:class:`MetricsTimeline`), sampled at
  the instants device state changes;
* a per-task **wait-state breakdown** (:data:`WAIT_STATES` taxonomy):
  dependency-wait, bandwidth-wait, capacity-blocked, failure-retry,
  running — plus the auxiliary executor/learning/offline/cpu states and an
  explicit unattributed/residual remainder, so every task's end-to-end
  latency is accounted for.

Design constraints (pinned by tests/test_obs.py):

* **inert when disabled** — every hook site guards on ``recorder is not
  None``; a disabled run costs one comparison per site and the launch log
  stays bit-identical (golden ``test_sched_scale`` is the proof);
* **pure reads** — recording never mutates scheduler/simulator state, so
  an *enabled* run is also bit-identical to a disabled one;
* **clock-agnostic** — timestamps come from the bound ``clock`` callable
  (``SimBackend.now`` = virtual seconds, ``RealBackend.now`` = monotonic
  seconds since backend start), never from ``time.*`` directly, so a
  seeded sim run exports a byte-identical trace every time;
* **thread-safe** — RealBackend completions arrive on worker threads; all
  mutators take the recorder's lock.
"""
from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Callable, Optional

_EPS = 1e-12

#: Frozen event catalog: event type -> required fields and their types.
#: ``t`` is seconds on the recorder's clock. New event types may be added;
#: existing fields are never removed or retyped (tests validate every
#: recorded event against this table).
EVENT_SCHEMA: dict[str, dict[str, tuple]] = {
    # task lifecycle (backends.py / runtime.py / scheduler.py)
    "submit":   {"t": (float,), "tid": (int,), "sig": (str,)},
    "ready":    {"t": (float,), "tid": (int,), "sig": (str,)},
    "launch":   {"t": (float,), "tid": (int,), "sig": (str,),
                 "worker": (str,), "device": (str, type(None)),
                 "tier": (str, type(None)), "bw": (float, int),
                 "attempt": (int,)},
    "complete": {"t": (float,), "tid": (int,), "sig": (str,),
                 "failed": (bool,)},
    "retry":    {"t": (float,), "tid": (int,), "sig": (str,),
                 "attempt": (int,)},
    # grant-refusal diagnosis (scheduler.py): why a ready class head could
    # not be placed at t (one event per reason *change* per class)
    "blocked":  {"t": (float,), "cls": (str,), "reason": (str,),
                 "device": (str, type(None)), "wanted_mb": (float, int)},
    # co-tenant burst boundaries (interference.py)
    "burst":    {"t": (float,), "device": (str,), "tier": (str, type(None)),
                 "phase": (str,), "streams": (int,), "bw": (float, int),
                 "capacity_mb": (float, int)},
    # device health transitions (failures.py)
    "health":   {"t": (float,), "device": (str,), "prev": (str,),
                 "state": (str,)},
    # data lifecycle (datalife.py): mode in {drop, discard, drain, lost}
    "evict":    {"t": (float,), "oid": (int,), "name": (str,),
                 "device": (str,), "tier": (str, type(None)),
                 "mode": (str,), "size_mb": (float, int)},
    "stage":    {"t": (float,), "oid": (int,), "name": (str,),
                 "tier": (str,), "size_mb": (float, int)},
    "pin":      {"t": (float,), "oid": (int,), "name": (str,),
                 "pinned": (bool,)},
    # checkpoint manager (checkpoint/manager.py): phase in
    # {save, wait, restore}; mode in {sync, flat, reroute, burst-buffer}
    "ckpt":     {"t": (float,), "phase": (str,), "step": (int,),
                 "mode": (str,), "n_shards": (int,)},
    # simulator stuck-path steps (backends.py): kind in {bg_step, fail_step}
    "stall":    {"t": (float,), "kind": (str,)},
    # measured real-backend throughput (obs/telemetry.py): one sample per
    # completed I/O op on a device — windowed aggregate MB/s, this op's
    # effective per-stream rate, queue depth after the completion. Never
    # appears in sim streams (the simulator has no TelemetryHub).
    "telemetry": {"t": (float,), "device": (str,),
                  "tier": (str, type(None)), "mbps": (float, int),
                  "stream_mbps": (float, int), "inflight": (int,),
                  "mb": (float, int), "wall_s": (float, int)},
    # generic async span (serve requests etc.): [t, t+dur]
    "span":     {"t": (float,), "name": (str,), "cat": (str,),
                 "dur": (float, int), "args": (dict,)},
}

#: Frozen wait-state taxonomy (docs/observability.md). The first five are
#: the paper-facing breakdown; the rest make the accounting exhaustive.
WAIT_STATES = (
    "dependency",     # submit -> first readiness (inputs not done)
    "bandwidth",      # ready, no device could allocate the storageBW
    "capacity",       # ready, output footprint does not fit any device
    "failure-retry",  # failed attempts' run time + requeue-to-relaunch
    "running",        # final successful attempt's execution
    "executor",       # ready, no free I/O executor on any candidate
    "learning",       # ready, waiting on a learning node / epoch admission
    "offline",        # ready, every eligible device offline
    "cpu",            # compute task waiting for computing units
    "unattributed",   # ready interval with no recorded refusal diagnosis
)


class TraceConfig:
    """Recorder knobs. ``timeline=False`` skips per-device sampling (the
    event stream and wait profile survive); ``waits=False`` skips the
    per-task attribution bookkeeping."""

    __slots__ = ("timeline", "waits")

    def __init__(self, timeline: bool = True, waits: bool = True):
        self.timeline = bool(timeline)
        self.waits = bool(waits)


class MetricsTimeline:
    """Per-device time series, sampled whenever a recorded event changes
    device state. One row per sample:

    ``(t, active_io, background_streams, allocated_bw, background_bw,
    available_bw, used_mb, reserved_mb, background_mb, occupancy_mb,
    health)``

    plus a scheduler series ``(t, n_ready, n_running, blocked_demand_mb)``
    (queue depth and capacity-blocked demand)."""

    ROW_FIELDS = ("t", "active_io", "background_streams", "allocated_bw",
                  "background_bw", "available_bw", "used_mb", "reserved_mb",
                  "background_mb", "occupancy_mb", "health")
    SCHED_FIELDS = ("t", "n_ready", "n_running", "blocked_demand_mb")
    #: measured telemetry is a SEPARATE per-device series (real runs only)
    #: so the modelled ROW_FIELDS schema above stays frozen
    TELEMETRY_FIELDS = ("t", "mbps", "stream_mbps", "inflight")

    def __init__(self):
        self.devices: dict[str, list[tuple]] = {}
        self.device_tiers: dict[str, Optional[str]] = {}
        self.sched: list[tuple] = []
        self.telemetry: dict[str, list[tuple]] = {}

    def sample_device(self, t: float, dev) -> None:
        rows = self.devices.get(dev.name)
        if rows is None:
            rows = self.devices[dev.name] = []
            self.device_tiers[dev.name] = dev.tier
        row = (t, dev.active_io, dev.background_streams,
               dev.bandwidth - dev.available_bw - dev.background_bw,
               dev.background_bw, dev.available_bw, dev.used_mb,
               dev.reserved_mb, dev.background_mb, dev.occupancy_mb,
               dev.health)
        if rows and rows[-1][0] == t:
            rows[-1] = row  # collapse same-instant samples to the latest
        else:
            rows.append(row)

    def sample_sched(self, t: float, n_ready: int, n_running: int,
                     blocked_mb: float) -> None:
        row = (t, n_ready, n_running, blocked_mb)
        if self.sched and self.sched[-1][0] == t:
            self.sched[-1] = row
        else:
            self.sched.append(row)

    def sample_telemetry(self, t: float, device: str, mbps: float,
                         stream_mbps: float, inflight: int) -> None:
        self.telemetry.setdefault(device, []).append(
            (t, mbps, stream_mbps, inflight))

    def device_rows(self, name: str) -> list[dict]:
        return [dict(zip(self.ROW_FIELDS, r))
                for r in self.devices.get(name, ())]

    def telemetry_rows(self, name: str) -> list[dict]:
        return [dict(zip(self.TELEMETRY_FIELDS, r))
                for r in self.telemetry.get(name, ())]


class _Wait:
    """Per-task wait bookkeeping (internal)."""

    __slots__ = ("tid", "sig", "cls", "submit_t", "ready_t", "last_ready_t",
                 "launch_t", "end_t", "retry_since", "attempts", "buckets")

    def __init__(self, tid: int, sig: str, submit_t: float):
        self.tid = tid
        self.sig = sig
        self.cls = None
        self.submit_t = submit_t
        self.ready_t = None       # first readiness (dependency-wait end)
        self.last_ready_t = None  # current attempt's readiness
        self.launch_t = None
        self.end_t = None
        self.retry_since = None   # set while re-queued after a failure
        self.attempts = 0
        self.buckets: dict[str, float] = {}

    def add(self, bucket: str, dt: float) -> None:
        if dt > 0:
            self.buckets[bucket] = self.buckets.get(bucket, 0.0) + dt

    def breakdown(self) -> dict:
        total = (self.end_t - self.submit_t) \
            if self.end_t is not None else 0.0
        out = {k: self.buckets.get(k, 0.0) for k in WAIT_STATES}
        residual = total - sum(out.values())
        out["total"] = total
        out["residual"] = residual
        out["coverage"] = 1.0 - abs(residual) / total if total > 0 else 1.0
        return out


class TraceRecorder:
    """Append-only typed event stream + metrics timeline + wait profiler.

    Construct with a ``clock`` callable (the backend's ``now``); the
    runtime binds it via :meth:`bind`."""

    def __init__(self, config: Optional[TraceConfig] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.config = config or TraceConfig()
        self._clock = clock or (lambda: 0.0)
        self._sched = None       # scheduler probe (queue depth sampling)
        self._lock = threading.Lock()
        self.events: list[dict] = []
        self.timeline = MetricsTimeline()
        self.waits: dict[int, _Wait] = {}
        # per placement-class refusal-reason marks: cls -> [(t, reason)],
        # appended only when the reason changes (segments extend until the
        # next different reason; see docs/observability.md)
        self._class_marks: dict = {}
        self._mark_times: dict = {}

    # ----------------------------------------------------------- wiring
    def bind(self, clock: Callable[[], float], scheduler=None) -> None:
        self._clock = clock
        self._sched = scheduler

    def now(self) -> float:
        return float(self._clock())

    # ------------------------------------------------------------ stream
    def event(self, type_: str, **fields) -> None:
        """Append one typed event (fields per :data:`EVENT_SCHEMA`)."""
        ev = {"type": type_, **fields}
        with self._lock:
            self.events.append(ev)

    def _sample_dev(self, t: float, dev) -> None:
        if self.config.timeline and dev is not None:
            self.timeline.sample_device(t, dev)

    def _sample_sched(self, t: float) -> None:
        sched = self._sched
        if not self.config.timeline or sched is None:
            return
        blocked = getattr(sched, "capacity_blocked", None)
        self.timeline.sample_sched(
            t, sched.n_ready, len(sched.running),
            float(sum(blocked.values())) if blocked else 0.0)

    # ----------------------------------------------------- task lifecycle
    def on_submit(self, task) -> None:
        t = task.submit_time
        with self._lock:
            self.events.append({"type": "submit", "t": t, "tid": task.tid,
                                "sig": task.defn.signature})
            if self.config.waits:
                self.waits[task.tid] = _Wait(
                    task.tid, task.defn.signature, t)

    def on_ready(self, task, cls: tuple) -> None:
        t = self.now()
        with self._lock:
            self.events.append({"type": "ready", "t": t, "tid": task.tid,
                                "sig": task.defn.signature})
            w = self.waits.get(task.tid)
            if w is None:
                return
            w.cls = cls
            if w.ready_t is None:
                w.ready_t = t
                w.add("dependency", t - w.submit_t)
            w.last_ready_t = t

    def on_launch(self, task, worker) -> None:
        t = task.start_time
        dev = task.device
        with self._lock:
            self.events.append({
                "type": "launch", "t": t, "tid": task.tid,
                "sig": task.defn.signature, "worker": worker.name,
                "device": dev.name if dev is not None else None,
                "tier": dev.tier if dev is not None else None,
                "bw": task.granted_bw, "attempt": task.retries})
            w = self.waits.get(task.tid)
            if w is not None:
                if w.retry_since is not None:
                    # requeue-to-relaunch window after a failed attempt
                    w.add("failure-retry", t - w.retry_since)
                    w.retry_since = None
                elif w.last_ready_t is not None:
                    self._attribute_ready_wait(w, w.last_ready_t, t)
                w.launch_t = t
                w.attempts += 1
        self._sample_dev(t, dev)
        self._sample_sched(t)

    def on_complete(self, task, failed: bool) -> None:
        t = task.end_time
        with self._lock:
            self.events.append({"type": "complete", "t": t, "tid": task.tid,
                                "sig": task.defn.signature,
                                "failed": bool(failed)})
            w = self.waits.get(task.tid)
            if w is not None and w.launch_t is not None:
                w.add("failure-retry" if failed else "running",
                      t - w.launch_t)
                w.end_t = t
        self._sample_dev(t, task.device)
        self._sample_sched(t)

    def on_retry(self, task) -> None:
        """A failed attempt re-enters the ready queue (SimBackend retry
        path). The attempt's run time and the wait until the next launch
        both land in the failure-retry bucket."""
        t = self.now()
        with self._lock:
            self.events.append({"type": "retry", "t": t, "tid": task.tid,
                                "sig": task.defn.signature,
                                "attempt": task.retries})
            w = self.waits.get(task.tid)
            if w is not None:
                if w.launch_t is not None:
                    w.add("failure-retry", t - w.launch_t)
                w.retry_since = t
        self._sample_dev(t, task.device)

    # -------------------------------------------------- refusal diagnosis
    def note_block(self, cls: tuple, reason: str,
                   device: Optional[str] = None,
                   wanted_mb: float = 0.0) -> None:
        """The scheduler could not place the head of placement class
        ``cls`` right now, for ``reason``. Marks extend until the next
        *different* reason, so the event stream stays O(reason changes)."""
        t = self.now()
        with self._lock:
            marks = self._class_marks.get(cls)
            if marks is None:
                marks = self._class_marks[cls] = []
                self._mark_times[cls] = []
            if marks and marks[-1][1] == reason:
                return
            marks.append((t, reason))
            self._mark_times[cls].append(t)
            self.events.append({"type": "blocked", "t": t, "cls": str(cls),
                                "reason": reason, "device": device,
                                "wanted_mb": float(wanted_mb)})
        self._sample_sched(t)

    def _attribute_ready_wait(self, w: _Wait, r: float, l: float) -> None:
        """Split the ready->launch interval ``[r, l]`` across the class's
        refusal-reason segments (called under the lock)."""
        if l - r <= _EPS:
            return
        marks = self._class_marks.get(w.cls)
        if not marks:
            w.add("unattributed", l - r)
            return
        times = self._mark_times[w.cls]
        i = bisect_right(times, r) - 1
        cur = r
        while cur < l - _EPS:
            if i < 0:
                seg_end = min(l, times[0])
                reason = "unattributed"
            else:
                reason = marks[i][1]
                seg_end = min(l, times[i + 1]) if i + 1 < len(marks) else l
            w.add(reason, seg_end - cur)
            cur = seg_end
            i += 1

    # ------------------------------------------------- subsystem hooks
    def on_burst(self, t: float, dev, phase: str, streams: int, bw: float,
                 capacity_mb: float) -> None:
        with self._lock:
            self.events.append({"type": "burst", "t": t, "device": dev.name,
                                "tier": dev.tier, "phase": phase,
                                "streams": int(streams), "bw": float(bw),
                                "capacity_mb": float(capacity_mb)})
        self._sample_dev(t, dev)

    def on_health(self, t: float, dev, prev: str, state: str) -> None:
        with self._lock:
            self.events.append({"type": "health", "t": t, "device": dev.name,
                                "prev": prev, "state": state})
        self._sample_dev(t, dev)

    def on_evict(self, t: float, obj, dev, mode: str) -> None:
        with self._lock:
            self.events.append({"type": "evict", "t": t, "oid": obj.oid,
                                "name": obj.name, "device": dev.name,
                                "tier": dev.tier, "mode": mode,
                                "size_mb": obj.size_mb})
        self._sample_dev(t, dev)

    def on_stage(self, t: float, obj, tier: str) -> None:
        with self._lock:
            self.events.append({"type": "stage", "t": t, "oid": obj.oid,
                                "name": obj.name, "tier": tier,
                                "size_mb": obj.size_mb})

    def on_pin(self, t: float, obj, pinned: bool) -> None:
        with self._lock:
            self.events.append({"type": "pin", "t": t, "oid": obj.oid,
                                "name": obj.name, "pinned": bool(pinned)})

    def on_ckpt(self, phase: str, step: int, mode: str,
                n_shards: int) -> None:
        self.event("ckpt", t=self.now(), phase=phase, step=int(step),
                   mode=mode, n_shards=int(n_shards))

    def on_stall(self, t: float, kind: str) -> None:
        self.event("stall", t=t, kind=kind)

    def on_telemetry(self, t: float, device: str, tier: Optional[str],
                     mbps: float, stream_mbps: float, inflight: int,
                     mb: float, wall_s: float) -> None:
        """Measured-throughput sample from the RealBackend's TelemetryHub
        (one per completed I/O op; real runs only)."""
        with self._lock:
            self.events.append({"type": "telemetry", "t": float(t),
                                "device": device, "tier": tier,
                                "mbps": float(mbps),
                                "stream_mbps": float(stream_mbps),
                                "inflight": int(inflight),
                                "mb": float(mb), "wall_s": float(wall_s)})
            if self.config.timeline:
                self.timeline.sample_telemetry(
                    t, device, float(mbps), float(stream_mbps),
                    int(inflight))

    def span(self, name: str, cat: str, t0: float, t1: float,
             **args) -> dict:
        """Record a generic async span (e.g. a serving request's
        admission->finish window). Returns the event dict."""
        ev = {"type": "span", "t": float(t0), "name": name, "cat": cat,
              "dur": float(t1) - float(t0), "args": args}
        with self._lock:
            self.events.append(ev)
        return ev

    # ----------------------------------------------------------- rollups
    def task_breakdown(self, tid: int) -> Optional[dict]:
        w = self.waits.get(tid)
        return w.breakdown() if w is not None else None

    def wait_state_summary(self) -> dict:
        """Attribution rollup: totals and per-signature sums over every
        finished task, with the residual reported explicitly. This is the
        dict ``rt.stats()`` exposes under ``"wait_states"``."""
        totals = {k: 0.0 for k in WAIT_STATES}
        by_sig: dict[str, dict] = {}
        residual = 0.0
        latency = 0.0
        n = 0
        min_cov = 1.0
        with self._lock:
            waits = list(self.waits.values())
        for w in waits:
            if w.end_t is None:
                continue
            b = w.breakdown()
            n += 1
            latency += b["total"]
            residual += abs(b["residual"])
            min_cov = min(min_cov, b["coverage"])
            sig = by_sig.setdefault(
                w.sig, {k: 0.0 for k in WAIT_STATES})
            for k in WAIT_STATES:
                totals[k] += b[k]
                sig[k] += b[k]
        return {
            "states": dict(totals),
            "by_signature": by_sig,
            "n_tasks": n,
            "total_latency": latency,
            "residual": residual,
            "min_task_coverage": min_cov,
        }

    def critical_path_report(self, graph) -> dict:
        """Walk the approximate critical path (from the last-finishing task
        back through each task's latest-finishing dependency) and sum the
        wait-state buckets along it — the per-run quantification of the
        paper's congestion claim: how much of the makespan is I/O
        contention (bandwidth + capacity) rather than work."""
        tasks = getattr(graph, "tasks", {})
        done = [w for w in self.waits.values() if w.end_t is not None]
        if not done:
            return {"path": [], "length": 0.0, "states": {},
                    "congestion_fraction": 0.0}
        tail = max(done, key=lambda w: (w.end_t, w.tid))
        path = []
        seen = set()
        w = tail
        while w is not None and w.tid not in seen:
            seen.add(w.tid)
            path.append(w.tid)
            t = tasks.get(w.tid)
            nxt = None
            if t is not None and t.deps:
                best = None
                for dep in t.deps:
                    # graph deps are TaskInstances; waits is keyed by tid
                    dw = self.waits.get(getattr(dep, "tid", dep))
                    if dw is None or dw.end_t is None:
                        continue
                    if best is None or (dw.end_t, dw.tid) > \
                            (best.end_t, best.tid):
                        best = dw
                nxt = best
            w = nxt
        path.reverse()
        states = {k: 0.0 for k in WAIT_STATES}
        for tid in path:
            b = self.waits[tid].breakdown()
            for k in WAIT_STATES:
                states[k] += b[k]
        length = tail.end_t - min(self.waits[t].submit_t for t in path)
        congestion = states["bandwidth"] + states["capacity"]
        return {
            "path": path,
            "length": length,
            "states": states,
            "congestion_fraction": congestion / length if length > 0
            else 0.0,
        }

    # ------------------------------------------------------------ export
    def to_jsonl(self) -> str:
        """The event stream as one JSON document per line (stable key
        order; byte-identical across same-seed sim runs)."""
        import json
        with self._lock:
            events = list(self.events)
        return "\n".join(json.dumps(ev, sort_keys=True) for ev in events)

    def summary(self) -> dict:
        by_type: dict[str, int] = {}
        with self._lock:
            for ev in self.events:
                by_type[ev["type"]] = by_type.get(ev["type"], 0) + 1
        return {
            "n_events": sum(by_type.values()),
            "events_by_type": by_type,
            "n_devices_sampled": len(self.timeline.devices),
            "wait_states": self.wait_state_summary(),
        }
