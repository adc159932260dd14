"""IOSan — inline runtime sanitizer for the discrete-event simulator.

``SimBackend(sanitize=True)`` calls :meth:`IOSanitizer.check` at every
event boundary of the simulation loop. The checks are the property-test
invariants (tests/test_properties.py) asserted *online*:

* device occupancy never exceeds capacity; no accounting counter negative;
* bandwidth claims (grants + co-tenant) never exceed the device budget;
* catalog residency agrees with device ``used_mb`` on every finite device;
* no scheduled reader on an object with no residency left (evicted);
* the simulation clock is monotonic; the scheduler's running set matches
  task states.

Every check is a pure read of runtime state — a sanitizer-on run produces
a launch log bit-identical to sanitizer-off. The first violation raises
:class:`SanitizerError` carrying the offending device/task and the recent
event trace (launch/complete ring buffer), instead of letting the
corruption surface as a confusing end-state assertion at the barrier.
"""
from __future__ import annotations

from collections import deque

from ..core.task import TaskState


class SanitizerError(AssertionError):
    """First invariant violation found by IOSan, with event trace."""


class IOSanitizer:
    """Event-boundary invariant checker driven by ``SimBackend``."""

    def __init__(self, trace_depth: int = 32):
        self.trace: deque = deque(maxlen=trace_depth)
        self.last_clock = float("-inf")
        self.n_checks = 0

    # ------------------------------------------------------------ event trace
    def record(self, kind: str, **info) -> None:
        self.trace.append((kind, info))

    def _fail(self, backend, msg: str) -> None:
        lines = [f"IOSan: {msg}",
                 f"  at t={backend.clock:.6f} "
                 f"(after {self.n_checks} clean checks)"]
        if self.trace:
            lines.append("  recent events (oldest first):")
            for kind, info in self.trace:
                detail = ", ".join(f"{k}={v}" for k, v in info.items())
                lines.append(f"    {kind}: {detail}")
        raise SanitizerError("\n".join(lines))

    # ---------------------------------------------------------------- checks
    def check(self, backend) -> None:
        """Assert every invariant; called by the sim loop at each event
        boundary. Read-only."""
        rt = backend.runtime
        if backend.clock < self.last_clock - 1e-9:
            self._fail(backend,
                       f"event time went backwards: {backend.clock} after "
                       f"{self.last_clock}")
        self.last_clock = backend.clock
        for dev in rt.cluster.devices:
            for msg in dev.check_invariants():
                self._fail(backend, msg)
        cat = rt.catalog
        if cat is not None and cat.enabled:
            self._check_catalog(backend, cat)
        graph = rt.graph
        for tid in rt.scheduler.running:
            t = graph.tasks.get(tid)
            if t is None or t.state != TaskState.RUNNING:
                state = "missing" if t is None else t.state.value
                self._fail(backend,
                           f"scheduler running-set lists task #{tid} but "
                           f"its graph state is {state}")
        self.n_checks += 1

    def _check_catalog(self, backend, cat) -> None:
        # residency <-> occupancy agreement: on every finite device, the
        # resident objects' sizes must sum to exactly what the device
        # accounts as committed (in-flight writers live in reserved_mb)
        for dev in cat._finite_devs:
            resident = cat._resident.get(id(dev), ())
            total = sum(o.size_mb for o in resident)
            if abs(total - dev.used_mb) > 1e-6:
                self._fail(backend,
                           f"residency/occupancy disagree on {dev.name}: "
                           f"resident objects sum to {total:.3f} MB but "
                           f"used_mb={dev.used_mb:.3f} "
                           f"({len(tuple(resident))} objects)")
        # an offline device holds nothing: on_device_offline must have
        # dropped every residency at the transition
        for dev in cat.cluster.devices:
            if dev.health != "offline":
                continue
            stale = cat._resident.get(id(dev))
            if stale:
                self._fail(backend,
                           f"offline device {dev.name} still lists "
                           f"{len(stale)} resident object(s): "
                           f"{sorted(o.name for o in stale)}")
        # no scheduled reader on an evicted object: eviction must never
        # select an object a submitted-but-unfinished consumer will read
        # (an object mid-recovery after a device failure is exempt — its
        # readers are exactly what the lineage re-run will re-feed)
        for obj in cat.objects.values():
            if obj.readers and not obj.residency and not obj.staging \
                    and not obj.recovering:
                self._fail(backend,
                           f"scheduled reader(s) {sorted(obj.readers)} on "
                           f"object {obj.name!r} with no residency left "
                           f"(evicted under a reader)")
