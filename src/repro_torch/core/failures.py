"""Failure domains: device/tier health states driven by scheduled events.

Generalizes per-task ``sim_fail=`` into whole storage devices (and whole
tiers) transitioning ``healthy -> degraded(bw_factor) -> offline`` at
simulated times. A :class:`FailureSchedule` is an ordered list of
:class:`FailureEvent`; :class:`FailureEngine` resolves each event's target
against the cluster and feeds the transitions to ``SimBackend`` as
first-class simulation events, peer to the interference engine's burst
heap (interference.py — the architectural template for this module).

Semantics on transition (see docs/failures.md):

* ``degraded(f)`` — the device keeps serving but its effective bandwidth
  drops to ``f * bandwidth``: the congestion model scales aggregate
  throughput, new grants must fit under the reduced budget, and
  co-tenant claims are clamped against it.
* ``offline`` — the scheduler stops granting to the device
  (``eligible_devices`` is health-aware), in-flight I/O on it fails into
  the ordinary retry path (a re-placement is a fresh grant on a surviving
  device), the catalog drops lost residencies and re-drains / re-runs
  lineage for objects whose only durable copy died with the device, and
  the checkpoint manager reroutes draining shards to the shared FS.
* back to ``healthy`` — the device rejoins the eligible set; nothing is
  replayed (recovered hardware comes back empty, residency is not
  resurrected).

An engine built from an empty schedule is inert: every code path — and
all simulator arithmetic — is identical to a run with no engine at all
(launch logs stay bit-identical; pinned by tests/test_failures.py).
"""
from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass
from typing import Iterable, Optional

HEALTH_STATES = ("healthy", "degraded", "offline")


@dataclass(frozen=True)
class FailureEvent:
    """One scheduled health transition.

    ``target`` names a tier label or a device name (resolved against the
    cluster at engine construction, like interference targets).
    ``bw_factor`` only matters for ``degraded``: the fraction of nameplate
    bandwidth the device retains."""

    t: float
    target: str
    state: str
    bw_factor: float = 1.0

    def __post_init__(self):
        if self.t < 0:
            raise ValueError(f"FailureEvent.t must be >= 0, got {self.t}")
        if self.state not in HEALTH_STATES:
            raise ValueError(
                f"FailureEvent.state must be one of {HEALTH_STATES}, "
                f"got {self.state!r}")
        if self.state == "degraded" and not (0.0 < self.bw_factor <= 1.0):
            raise ValueError(
                f"degraded bw_factor must be in (0, 1], got {self.bw_factor}")


class FailureSchedule:
    """An ordered, reproducible list of :class:`FailureEvent`.

    Stable-sorted by time: two events at the same instant apply in the
    order given (so ``[... offline, ... healthy]`` at equal t ends
    healthy)."""

    def __init__(self, events: Iterable[FailureEvent] = ()):
        evs = []
        for ev in events:
            if not isinstance(ev, FailureEvent):
                ev = FailureEvent(*ev)
            evs.append(ev)
        self.events: tuple[FailureEvent, ...] = tuple(
            sorted(evs, key=lambda e: e.t))

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    @classmethod
    def seeded(cls, seed: int, targets, horizon: float,
               n_events: int = 3, offline_prob: float = 0.5,
               recover: bool = True, min_factor: float = 0.25,
               max_factor: float = 0.9) -> "FailureSchedule":
        """Draw a reproducible schedule: ``n_events`` fault injections over
        ``[0, horizon)`` against the given tier/device targets, each going
        offline with ``offline_prob`` (else degraded with a bandwidth
        factor in ``[min_factor, max_factor]``), optionally recovering to
        healthy before the horizon."""
        rng = random.Random(seed)
        targets = list(targets)
        if not targets:
            raise ValueError("FailureSchedule.seeded needs >= 1 target")
        events: list[FailureEvent] = []
        for _ in range(n_events):
            target = rng.choice(targets)
            t = rng.uniform(0.0, horizon)
            if rng.random() < offline_prob:
                events.append(FailureEvent(t, target, "offline"))
            else:
                f = rng.uniform(min_factor, max_factor)
                events.append(FailureEvent(t, target, "degraded", f))
            if recover:
                t_back = rng.uniform(t, horizon)
                events.append(FailureEvent(t_back, target, "healthy"))
        return cls(events)


class _Binding:
    """One (device, event) pair on the engine's heap."""

    __slots__ = ("device", "event")

    def __init__(self, device, event: FailureEvent):
        self.device = device
        self.event = event


class FailureEngine:
    """Applies a :class:`FailureSchedule` to a cluster's devices as the
    simulation clock advances. Mirrors ``InterferenceEngine``'s contract:
    ``next_time()`` feeds the event loop's horizon, ``apply_due(now)``
    fires everything due and returns the transitions that happened."""

    def __init__(self, schedule, cluster):
        if not isinstance(schedule, FailureSchedule):
            schedule = FailureSchedule(schedule)
        self.schedule = schedule
        self.cluster = cluster
        self._seq = itertools.count()
        self._heap: list[tuple[float, int, _Binding]] = []
        self.log: list[tuple[float, str, str, str]] = []  # (t, dev, prev, new)
        # trace recorder (obs/): wired by the runtime when tracing is on;
        # None costs one comparison per fired transition
        self.recorder = None
        self.n_transitions = 0
        self._final: dict[int, FailureEvent] = {}  # id(dev) -> last event
        for ev in schedule.events:
            devs = [d for d in cluster.devices
                    if d.tier == ev.target or d.name == ev.target]
            if not devs:
                tiers = cluster.tier_names()
                names = sorted(d.name for d in cluster.devices)
                raise ValueError(
                    f"FailureEvent target {ev.target!r} matches no tier "
                    f"(available: {tiers}) and no device (available: "
                    f"{names})")
            for d in devs:
                heapq.heappush(self._heap,
                               (ev.t, next(self._seq), _Binding(d, ev)))
                self._final[id(d)] = ev

    @property
    def active(self) -> bool:
        """True when the schedule carries any event at all. An inactive
        engine is dropped by ``SimBackend.attach_failures`` so the
        simulator arithmetic stays byte-identical to a failure-free run."""
        return bool(self.schedule.events)

    def next_time(self) -> float:
        return self._heap[0][0] if self._heap else float("inf")

    def apply_due(self, now: float, eps: float = 1e-9) -> list:
        """Fire every event with ``t <= now + eps``; returns the list of
        ``(device, prev_state, new_state)`` transitions applied (possibly
        empty). Same-instant events apply in schedule order."""
        transitions = []
        while self._heap and self._heap[0][0] <= now + eps:
            _, _, b = heapq.heappop(self._heap)
            dev, ev = b.device, b.event
            prev = dev.health
            dev.set_health(ev.state, ev.bw_factor)
            self.n_transitions += 1
            self.log.append((ev.t, dev.name, prev, ev.state))
            if self.recorder is not None:
                self.recorder.on_health(ev.t, dev, prev, ev.state)
            transitions.append((dev, prev, ev.state))
        return transitions

    def final_state(self, dev) -> Optional[str]:
        """The health state the schedule leaves ``dev`` in once every event
        has fired — None when the schedule never touches it. Used by the
        static analyzer (IO501) to flag durable tiers the schedule kills
        without recovery."""
        ev = self._final.get(id(dev))
        return ev.state if ev is not None else None

    def summary(self) -> dict:
        return {
            "events": len(self.schedule),
            "transitions": self.n_transitions,
            "pending": len(self._heap),
            "log": list(self.log),
        }
