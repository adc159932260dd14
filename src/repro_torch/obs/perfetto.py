"""Chrome trace-event (Perfetto) export for a :class:`TraceRecorder`.

Layout (one process per track group, ``ui.perfetto.dev`` renders each as
a collapsible track):

* pid 1 — **tasks**: one thread per worker, "X" complete events for every
  task attempt; data movers (``tier_drain`` / ``tier_prefetch`` /
  ``lineage_recover`` signatures) additionally emit "b"/"e" async spans
  on their device's pid so transfers line up with tier state.
* pid 2 — **requests**: async spans recorded via ``recorder.span`` (the
  serve loop's admission -> first-token -> finish windows) and checkpoint
  save/wait/restore phases.
* pid 10+k — one per **device**, named ``tier:<tier> <device>``: burst
  "b"/"e" async spans, health-transition and eviction "i" instants, and
  "C" counter tracks from the metrics timeline (allocated vs background
  bandwidth, occupancy, active streams).

Timestamps are microseconds (recorder seconds x 1e6). All ids derive from
deterministic counters and the dump sorts keys, so a seeded sim run
exports byte-identical JSON (pinned by tests/test_obs.py).
"""
from __future__ import annotations

import json


def _us(t: float) -> float:
    return round(float(t) * 1e6, 3)


def to_perfetto(recorder) -> dict:
    """Build the ``{"traceEvents": [...]}`` document for ``recorder``."""
    events = list(recorder.events)
    out: list[dict] = []

    def meta(pid: int, name: str) -> None:
        out.append({"ph": "M", "pid": pid, "tid": 0,
                    "name": "process_name", "args": {"name": name}})

    meta(1, "tasks")
    meta(2, "requests")

    # stable pid/tid assignment in first-seen order
    device_pid: dict[str, int] = {}
    worker_tid: dict[str, int] = {}

    def dev_pid(name: str, tier) -> int:
        pid = device_pid.get(name)
        if pid is None:
            pid = device_pid[name] = 10 + len(device_pid)
            meta(pid, f"tier:{tier or '-'} {name}")
        return pid

    def wtid(name: str) -> int:
        tid = worker_tid.get(name)
        if tid is None:
            tid = worker_tid[name] = 1 + len(worker_tid)
            out.append({"ph": "M", "pid": 1, "tid": tid,
                        "name": "thread_name", "args": {"name": name}})
        return tid

    # pre-register device pids from the timeline so counter tracks exist
    # even for devices that never appear in a discrete event
    for name in recorder.timeline.devices:
        dev_pid(name, recorder.timeline.device_tiers.get(name))

    open_launch: dict[int, dict] = {}   # tid -> launch event
    span_id = 0
    mover_sigs = ("tier_drain", "tier_prefetch", "lineage_recover")

    for ev in events:
        et = ev["type"]
        if et == "launch":
            open_launch[ev["tid"]] = ev
        elif et in ("complete", "retry"):
            la = open_launch.pop(ev["tid"], None)
            if la is None:
                continue
            dur = _us(ev["t"]) - _us(la["t"])
            args = {"tid": ev["tid"], "device": la["device"],
                    "tier": la["tier"], "bw": la["bw"],
                    "attempt": la["attempt"]}
            if et == "retry" or ev.get("failed"):
                args["failed"] = True
            out.append({"ph": "X", "pid": 1, "tid": wtid(la["worker"]),
                        "ts": _us(la["t"]), "dur": dur, "name": la["sig"],
                        "cat": "task", "args": args})
            sig = la["sig"]
            if la["device"] is not None and \
                    any(sig.startswith(m) for m in mover_sigs):
                pid = dev_pid(la["device"], la["tier"])
                span_id += 1
                base = {"pid": pid, "tid": 0, "cat": "mover",
                        "id": span_id, "name": sig}
                out.append({**base, "ph": "b", "ts": _us(la["t"]),
                            "args": args})
                out.append({**base, "ph": "e", "ts": _us(ev["t"])})
        elif et == "burst":
            pid = dev_pid(ev["device"], ev["tier"])
            base = {"pid": pid, "tid": 0, "cat": "burst",
                    "name": "background_burst"}
            if ev["phase"] == "start":
                span_id += 1
                out.append({**base, "ph": "b", "id": span_id,
                            "ts": _us(ev["t"]),
                            "args": {"streams": ev["streams"],
                                     "bw": ev["bw"],
                                     "capacity_mb": ev["capacity_mb"]}})
            else:
                out.append({**base, "ph": "e", "id": span_id,
                            "ts": _us(ev["t"])})
        elif et == "health":
            pid = dev_pid(ev["device"], None)
            out.append({"ph": "i", "pid": pid, "tid": 0, "s": "p",
                        "ts": _us(ev["t"]), "cat": "health",
                        "name": f"health:{ev['prev']}->{ev['state']}",
                        "args": {"prev": ev["prev"],
                                 "state": ev["state"]}})
        elif et == "evict":
            pid = dev_pid(ev["device"], ev["tier"])
            out.append({"ph": "i", "pid": pid, "tid": 0, "s": "p",
                        "ts": _us(ev["t"]), "cat": "evict",
                        "name": f"evict:{ev['mode']}",
                        "args": {"object": ev["name"],
                                 "mode": ev["mode"],
                                 "size_mb": ev["size_mb"]}})
        elif et == "ckpt":
            span_id += 1
            out.append({"ph": "i", "pid": 2, "tid": 0, "s": "g",
                        "ts": _us(ev["t"]), "cat": "ckpt",
                        "name": f"ckpt:{ev['phase']}",
                        "args": {"step": ev["step"], "mode": ev["mode"],
                                 "n_shards": ev["n_shards"]}})
        elif et == "telemetry":
            # measured real-backend throughput as counter tracks on the
            # device's pid, alongside the modelled bandwidth counters
            pid = dev_pid(ev["device"], ev["tier"])
            ts = _us(ev["t"])
            out.append({"ph": "C", "pid": pid, "tid": 0, "ts": ts,
                        "name": "measured_mbs",
                        "args": {"window": ev["mbps"],
                                 "stream": ev["stream_mbps"]}})
            out.append({"ph": "C", "pid": pid, "tid": 0, "ts": ts,
                        "name": "measured_inflight",
                        "args": {"inflight": ev["inflight"]}})
        elif et == "span":
            span_id += 1
            base = {"pid": 2, "tid": 0, "cat": ev["cat"],
                    "id": span_id, "name": ev["name"]}
            out.append({**base, "ph": "b", "ts": _us(ev["t"]),
                        "args": dict(ev["args"])})
            out.append({**base, "ph": "e",
                        "ts": _us(ev["t"] + ev["dur"])})

    # counter tracks from the metrics timeline
    for name in recorder.timeline.devices:
        pid = device_pid[name]
        for row in recorder.timeline.device_rows(name):
            ts = _us(row["t"])
            out.append({"ph": "C", "pid": pid, "tid": 0, "ts": ts,
                        "name": "bandwidth_mbs",
                        "args": {"allocated": row["allocated_bw"],
                                 "background": row["background_bw"],
                                 "free": row["available_bw"]}})
            out.append({"ph": "C", "pid": pid, "tid": 0, "ts": ts,
                        "name": "occupancy_mb",
                        "args": {"used": row["used_mb"],
                                 "reserved": row["reserved_mb"],
                                 "background": row["background_mb"]}})
            out.append({"ph": "C", "pid": pid, "tid": 0, "ts": ts,
                        "name": "streams",
                        "args": {"tasks": row["active_io"],
                                 "background":
                                     row["background_streams"]}})
    for row in recorder.timeline.sched:
        out.append({"ph": "C", "pid": 1, "tid": 0, "ts": _us(row[0]),
                    "name": "scheduler",
                    "args": {"ready": row[1], "running": row[2],
                             "blocked_demand_mb": row[3]}})

    return {"traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"generator": "repro.obs", "schema": 1}}


def dumps(recorder) -> str:
    """Deterministic (sorted-keys) JSON dump of the Perfetto document."""
    return json.dumps(to_perfetto(recorder), sort_keys=True,
                      separators=(",", ":"))
