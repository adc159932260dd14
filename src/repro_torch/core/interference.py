"""Co-tenant interference subsystem: background traffic on shared tiers.

The runtime's shared devices (burst buffer, parallel FS) are cluster-global
budgets, but until now only *this* runtime's tasks drew from them — the
autotuner therefore learned constraints that hold only when the runtime is
the cluster's sole tenant. This module injects **background load** from
co-tenant applications into :class:`~repro.core.resources.StorageDevice`\\ s
so that calibration, steady-state scheduling and the eviction machinery all
see the storage the cluster actually provides, not its nameplate.

Two interference channels, both first-class consumers of the device budgets
(resources.py):

* **Bandwidth interference** — a burst joins the congestion model with its
  own fair-share streams (our tasks' per-task rate drops to
  ``A(k + bg) / (k + bg)``) and takes bandwidth out of the allocatable
  budget, so the scheduler cannot grant constraints the co-tenant is
  already using. Claims are clamped to the free budget: a co-tenant can
  *contend*, never *over-commit*.
* **Capacity interference** — a co-tenant fills tier capacity (its own
  checkpoints landing on the shared burst buffer). The filled space counts
  toward occupancy, so it can push a tier over its eviction watermarks
  (datalife.py synthesizes drains of *our* cold objects) and capacity-block
  our grants. Also clamped: the device never overfills.

Traffic models (pluggable, all deterministic)
---------------------------------------------
:class:`ConstantTraffic`
    A steady co-tenant: fixed streams/bandwidth/capacity from ``start`` on.
:class:`BurstyTraffic`
    Seeded stochastic on–off bursts (exponential on/off durations via
    ``random.Random(seed)``): the classic checkpointing co-tenant. The same
    seed always produces the same burst train — runs are bit-reproducible.
:class:`TraceTraffic`
    Replay of an explicit schedule; :meth:`TraceTraffic.from_jsonl` loads
    the simple JSONL schema (one event per line)::

        {"t": 10.0, "dur": 5.0, "streams": 32, "bw": 400.0, "capacity_mb": 0}

The :class:`InterferenceEngine` binds models to devices (by tier label or
device name), turns their interval streams into a deterministic event heap,
and is driven by ``SimBackend``'s event loop: burst starts/ends are
simulation events exactly like task finishes, so rates integrate piecewise
between them. With no engine attached (or no bindings) the simulator's
arithmetic is bit-identical to the interference-free implementation — the
golden-parity suite pins this.

Interference is a *simulation* concept: ``RealBackend`` refuses an engine
(real co-tenants are injected by the cluster, not by us).
"""
from __future__ import annotations

import heapq
import itertools
import json
import random
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional, Tuple

from .resources import Cluster, StorageDevice

_INF = float("inf")


@dataclass(frozen=True)
class Burst:
    """One background interval: at ``start`` (seconds), for ``duration``
    seconds, the co-tenant holds ``streams`` congestion-model streams,
    ``bw`` MB/s of allocatable bandwidth and ``capacity_mb`` MB of tier
    capacity (each clamped at claim time)."""

    start: float
    duration: float
    streams: int = 1
    bw: float = 0.0
    capacity_mb: float = 0.0

    def __post_init__(self):
        if self.start < 0:
            raise ValueError(f"burst start must be >= 0, got {self.start}")
        if self.duration <= 0:
            raise ValueError(
                f"burst duration must be positive, got {self.duration}")
        if self.streams < 0 or self.bw < 0 or self.capacity_mb < 0:
            raise ValueError(
                f"burst streams/bw/capacity_mb must be non-negative "
                f"(got {self.streams}/{self.bw}/{self.capacity_mb})")


class TrafficModel:
    """A deterministic stream of :class:`Burst` intervals."""

    def bursts(self) -> Iterator[Burst]:
        raise NotImplementedError


class ConstantTraffic(TrafficModel):
    """A co-tenant that is always there (one burst from ``start`` to
    ``until``, default forever)."""

    def __init__(self, streams: int = 1, bw: float = 0.0,
                 capacity_mb: float = 0.0, start: float = 0.0,
                 until: float = _INF):
        if until <= start:
            raise ValueError(f"until ({until}) must exceed start ({start})")
        self._burst = Burst(start=start, duration=until - start,
                            streams=streams, bw=bw, capacity_mb=capacity_mb)

    def bursts(self) -> Iterator[Burst]:
        yield self._burst


class BurstyTraffic(TrafficModel):
    """Seeded stochastic on–off traffic.

    Off/on durations are exponential with means ``off_mean``/``on_mean``
    (the memoryless arrival process of an independent co-tenant); the
    generator is ``random.Random(seed)``, so the burst train is a pure
    function of the constructor arguments. ``until`` bounds the train (a
    burst straddling ``until`` is truncated to it).

    ``seed=None`` is allowed but draws the train from OS entropy — runs
    stop being reproducible, and the static analyzer flags every such
    model bound to a device (diagnostic ``IO401``, ``seeded`` False).
    """

    def __init__(self, seed: Optional[int], on_mean: float, off_mean: float,
                 streams: int = 1, bw: float = 0.0,
                 capacity_mb: float = 0.0, until: float = _INF):
        if on_mean <= 0 or off_mean <= 0:
            raise ValueError(
                f"on_mean/off_mean must be positive "
                f"(got {on_mean}/{off_mean})")
        self.seed = None if seed is None else int(seed)
        self.seeded = self.seed is not None
        self.on_mean = float(on_mean)
        self.off_mean = float(off_mean)
        self.streams = int(streams)
        self.bw = float(bw)
        self.capacity_mb = float(capacity_mb)
        self.until = float(until)

    def bursts(self) -> Iterator[Burst]:
        rng = random.Random(self.seed)
        t = 0.0
        while True:
            t += rng.expovariate(1.0 / self.off_mean)
            if t >= self.until:
                return
            dur = rng.expovariate(1.0 / self.on_mean)
            dur = min(dur, self.until - t)
            if dur > 0:
                yield Burst(start=t, duration=dur, streams=self.streams,
                            bw=self.bw, capacity_mb=self.capacity_mb)
            t += dur


class TraceTraffic(TrafficModel):
    """Replay an explicit burst schedule (e.g. recorded from a real
    co-tenant). Bursts may be given in any order; replay is by start time."""

    def __init__(self, bursts: Iterable[Burst]):
        self._bursts = sorted(bursts, key=lambda b: (b.start, b.duration))

    def bursts(self) -> Iterator[Burst]:
        return iter(self._bursts)

    @staticmethod
    def from_jsonl(path_or_lines) -> "TraceTraffic":
        """Load the JSONL schedule schema: one object per line with keys
        ``t`` (start, required), ``dur`` (required) and optional
        ``streams``/``bw``/``capacity_mb``. Accepts a file path or any
        iterable of lines (so tests can pass strings directly)."""
        if isinstance(path_or_lines, str):
            with open(path_or_lines) as f:
                lines = f.readlines()
        else:
            lines = list(path_or_lines)
        out = []
        for i, line in enumerate(lines):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"trace line {i + 1}: invalid JSON ({e})") from e
            if not isinstance(rec, dict):
                raise ValueError(
                    f"trace line {i + 1}: expected a JSON object, got "
                    f"{type(rec).__name__} ({line[:60]!r})")
            if "t" not in rec or "dur" not in rec:
                raise ValueError(
                    f"trace line {i + 1}: needs 't' and 'dur' keys, got "
                    f"{sorted(rec)}")
            try:
                out.append(Burst(
                    start=float(rec["t"]),
                    duration=float(rec["dur"]),
                    streams=int(rec.get("streams", 1)),
                    bw=float(rec.get("bw", 0.0)),
                    capacity_mb=float(rec.get("capacity_mb", 0.0))))
            except (TypeError, ValueError) as e:
                # malformed values (negative duration, non-numeric fields)
                # surface with the line number instead of a bare Burst/
                # float error from deep inside model construction
                raise ValueError(
                    f"trace line {i + 1}: invalid record ({e})") from e
        return TraceTraffic(out)


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------
class _Binding:
    """One (device, model) pair with its lazily-pulled burst iterator."""

    __slots__ = ("device", "model", "it", "next_burst")

    def __init__(self, device: StorageDevice, model: TrafficModel):
        self.device = device
        self.model = model
        self.it = model.bursts()
        self.next_burst: Optional[Burst] = next(self.it, None)

    def pull(self) -> Optional[Burst]:
        b, self.next_burst = self.next_burst, next(self.it, None)
        return b


class InterferenceEngine:
    """Deterministic event source of co-tenant traffic for the simulator.

    Construct with ``targets``: an iterable of ``(target, model)`` where
    ``target`` is a tier label (every device of the tier gets the model) or
    a device name. The engine exposes :meth:`next_time` /
    :meth:`apply_due`; ``SimBackend`` treats burst boundaries as simulation
    events. Each applied start records what was *actually* claimed (clamped
    to the device's free budgets) so the matching end returns exactly that.
    """

    def __init__(self, targets: Iterable[Tuple[str, TrafficModel]],
                 cluster: Cluster):
        self.cluster = cluster
        self._bindings: list[_Binding] = []
        for target, model in targets:
            if not isinstance(model, TrafficModel):
                raise TypeError(
                    f"interference target {target!r}: model must be a "
                    f"TrafficModel, got {type(model).__name__}")
            devs = [d for d in cluster.devices
                    if d.tier == target or d.name == target]
            if not devs:
                raise ValueError(
                    f"interference target {target!r} matches no tier or "
                    f"device (tiers: {cluster.tier_names()}, devices: "
                    f"{[d.name for d in cluster.devices]})")
            for d in devs:
                self._bindings.append(_Binding(d, model))
        # event heap: (time, kind, seq, payload) — kind 0 = burst end,
        # 1 = burst start, so an end at time t applies before a start at t
        # (back-to-back bursts hand the budget over cleanly)
        self._heap: list = []
        self._seq = itertools.count()
        for i, b in enumerate(self._bindings):
            burst = b.pull()
            if burst is not None:
                heapq.heappush(self._heap,
                               (burst.start, 1, next(self._seq), (i, burst)))
        # trace recorder (obs/): wired by the runtime when tracing is on;
        # None costs one comparison per burst boundary
        self.recorder = None
        # stats
        self.n_bursts = 0
        self.bg_busy_time: dict[str, float] = {}     # device -> burst seconds
        #                                              (finite bursts only)
        self.bg_unbounded: dict[str, int] = {}       # device -> #never-ending
        #                                              bursts (until=inf)
        self.bg_capacity_peak: dict[str, float] = {} # device -> max bg MB held
        self.bg_bw_peak: dict[str, float] = {}       # device -> max bg MB/s

    @property
    def active(self) -> bool:
        return bool(self._bindings)

    def next_time(self) -> float:
        return self._heap[0][0] if self._heap else _INF

    def apply_due(self, now: float, eps: float = 1e-9) -> bool:
        """Apply every burst boundary at or before ``now``. Returns True if
        any boundary was applied (rates/budgets changed: the caller must
        refresh stale finish estimates and re-run a schedule pass)."""
        applied = False
        while self._heap and self._heap[0][0] <= now + eps:
            _, kind, _, payload = heapq.heappop(self._heap)
            if kind == 1:
                self._start_burst(*payload)
            else:
                self._end_burst(*payload)
            applied = True
        return applied

    def _start_burst(self, bi: int, burst: Burst) -> None:
        b = self._bindings[bi]
        dev = b.device
        taken_bw = dev.add_background(burst.streams, burst.bw)
        taken_mb = dev.add_background_capacity(burst.capacity_mb)
        if self.recorder is not None:
            # what was actually claimed (clamped), not the model's ask
            self.recorder.on_burst(burst.start, dev, "start",
                                   burst.streams, taken_bw, taken_mb)
        self.n_bursts += 1
        if burst.duration != _INF:
            self.bg_busy_time[dev.name] = \
                self.bg_busy_time.get(dev.name, 0.0) + burst.duration
        else:
            # a steady co-tenant (until=inf): count it rather than poison
            # the summary with an Infinity that strict JSON rejects
            self.bg_unbounded[dev.name] = \
                self.bg_unbounded.get(dev.name, 0) + 1
        self.bg_capacity_peak[dev.name] = max(
            self.bg_capacity_peak.get(dev.name, 0.0), dev.background_mb)
        self.bg_bw_peak[dev.name] = max(
            self.bg_bw_peak.get(dev.name, 0.0), dev.background_bw)
        end = burst.start + burst.duration
        heapq.heappush(self._heap, (end, 0, next(self._seq),
                                    (bi, burst, taken_bw, taken_mb)))
        # pull the binding's next burst into the heap
        nxt = b.pull()
        if nxt is not None:
            heapq.heappush(self._heap,
                           (nxt.start, 1, next(self._seq), (bi, nxt)))

    def _end_burst(self, bi: int, burst: Burst, taken_bw: float,
                   taken_mb: float) -> None:
        dev = self._bindings[bi].device
        dev.remove_background(burst.streams, taken_bw)
        dev.remove_background_capacity(taken_mb)
        if self.recorder is not None:
            self.recorder.on_burst(burst.start + burst.duration, dev, "end",
                                   burst.streams, taken_bw, taken_mb)

    def summary(self) -> dict:
        return {
            "n_bursts": self.n_bursts,
            "bg_busy_time": dict(self.bg_busy_time),
            "bg_unbounded_bursts": dict(self.bg_unbounded),
            "bg_capacity_peak_mb": dict(self.bg_capacity_peak),
            "bg_bw_peak_mbs": dict(self.bg_bw_peak),
            "devices": {
                b.device.name: b.device.tier for b in self._bindings},
        }
