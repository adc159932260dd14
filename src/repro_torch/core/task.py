"""Task model for the I/O-aware runtime.

Mirrors PyCOMPSs semantics (paper §4.1.1): functions become tasks via
decorators; parameter directionality (IN/INOUT/OUT) drives dependency
detection; tasks return Futures; ``@io`` marks a task as an I/O task whose
*computing* requirement is zero (paper §4.2.1) so it is scheduled on the I/O
execution platform and may overlap with compute tasks.
"""
from __future__ import annotations

import enum
import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .constraints import ConstraintSpec


class Direction(enum.Enum):
    IN = "in"
    INOUT = "inout"
    OUT = "out"


IN = Direction.IN
INOUT = Direction.INOUT
OUT = Direction.OUT


class TaskType(enum.Enum):
    COMPUTE = "compute"
    IO = "io"


class TaskState(enum.Enum):
    PENDING = "pending"      # submitted, deps not satisfied
    READY = "ready"          # deps satisfied, waiting for resources
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"


@dataclass
class TaskDef:
    """Static definition attached to a decorated function."""

    fn: Callable
    name: str
    task_type: TaskType = TaskType.COMPUTE
    computing_units: int = 1
    storage_bw: Optional[ConstraintSpec] = None
    storage_tier: Optional[str] = None  # tier hint (None: fastest-with-budget)
    param_dirs: dict = field(default_factory=dict)  # name -> Direction
    returns: int = 0
    max_retries: int = 0  # I/O fault tolerance: bounded retries

    @property
    def signature(self) -> str:
        return self.name


class Future:
    """Future returned by a task invocation (one per declared return)."""

    __slots__ = ("task", "index", "_value", "_set")

    def __init__(self, task: "TaskInstance", index: int = 0):
        self.task = task
        self.index = index
        self._value = None
        self._set = False

    def set_value(self, value: Any) -> None:
        self._value = value
        self._set = True

    def resolved(self) -> bool:
        return self._set

    def value(self) -> Any:
        return self._value

    def __repr__(self) -> str:
        return f"<Future {self.task.defn.name}#{self.task.tid}[{self.index}]>"


class DataHandle:
    """Mutable datum tracked with versions (COMPSs renaming).

    Pass a DataHandle to an INOUT/OUT parameter to get write-after-read /
    write-after-write serialization.
    """

    _ids = itertools.count()

    def __init__(self, value: Any = None, name: str | None = None):
        self.did = next(DataHandle._ids)
        self.name = name or f"data{self.did}"
        self.value = value
        # dependency bookkeeping (owned by TaskGraph)
        self.last_writer: Optional["TaskInstance"] = None
        self.readers_since_write: list["TaskInstance"] = []
        self.version = 0

    def __repr__(self) -> str:
        return f"<DataHandle {self.name} v{self.version}>"


@dataclass
class SimSpec:
    """Simulation-mode execution model for a task instance."""

    duration: float = 0.0        # compute time, seconds (virtual)
    io_bytes: float = 0.0        # MB to write/read for I/O tasks
    fail: "bool | int" = False   # fault injection: the task FAILs at its
    #                              (normally computed) end time, exercising
    #                              the retry path and, once retries are
    #                              exhausted, descendant cancellation.
    #                              True: every attempt fails; an int N:
    #                              only the first N attempts fail (with
    #                              maxRetries >= N the task succeeds)


class TaskInstance:
    _ids = itertools.count()

    # __slots__: at the 1M-task bench scale (benchmarks/sched_scale.py)
    # the per-instance attribute dict dominates live memory — the launch
    # log keeps every instance alive to the end of the run, and the cache
    # pressure of those dicts is what bends the per-task cost superlinear.
    # _plan_seq is capture-mode-only and deliberately left unset elsewhere
    # (the lint rules read it via getattr-with-default).
    __slots__ = (
        "tid", "defn", "args", "kwargs", "sim", "storage_bw", "tier",
        "state", "deps", "anti_deps", "children", "futures", "worker",
        "device", "granted_bw", "tuner_key", "reserved_mb", "read_penalty",
        "_datalife", "submit_time", "start_time", "end_time",
        "measured_duration", "_telemetry_k", "epoch", "retries", "error",
        "_ready_seq", "_sim_seq", "shard", "shard_key", "_plan_seq")

    def __init__(self, defn: TaskDef, args: tuple, kwargs: dict,
                 sim: SimSpec | None = None,
                 storage_bw: Optional[ConstraintSpec] = None,
                 storage_tier: Optional[str] = None):
        self.tid = next(TaskInstance._ids)
        self.defn = defn
        self.args = args
        self.kwargs = kwargs
        self.sim = sim or SimSpec()
        # per-instance constraint override (else defn.storage_bw)
        self.storage_bw = storage_bw if storage_bw is not None else defn.storage_bw
        # resolved tier hint: per-call override, else the @constraint hint,
        # else None = tier-agnostic (fastest tier with budget wins)
        self.tier = storage_tier if storage_tier is not None else defn.storage_tier
        self.state = TaskState.PENDING
        self.deps: set[int] = set()          # tids this task waits on
        self.anti_deps: set[int] = set()     # subset of deps that are
        #                                      ordering-only (write-after-read)
        self.children: list[int] = []        # dependents, by tid (submission
        #                                      order; resolved via TaskGraph)
        self.futures = [Future(self, i) for i in range(max(defn.returns, 1))]
        # filled by the scheduler/backend
        self.worker = None
        self.device = None                   # StorageDevice the I/O was
        #                                      granted on (a tier of .worker)
        self.granted_bw: float = 0.0         # bandwidth reserved at launch
        self.tuner_key: Optional[str] = None  # the (signature, tier) tuner
        #                                      this grant drew from — under
        #                                      the measured tier objective a
        #                                      tier-agnostic task may be
        #                                      granted on any tier's tuner
        self.reserved_mb: float = 0.0        # capacity reserved at grant on
        #                                      .device (commit-at-finish)
        self.read_penalty: float = 0.0       # simulated input-read floor
        #                                      (datalife catalog, at grant)
        self._datalife = None                # lifecycle mover tag:
        #                                      ("stage"|"evict", obj, ...)
        self.submit_time: float = 0.0
        self.start_time: float = 0.0
        self.end_time: float = 0.0
        self.measured_duration: Optional[float] = None  # wall time of the
        #                                      final successful attempt alone
        #                                      (RealBackend). duration =
        #                                      end-start also counts pool
        #                                      queueing, argument resolution
        #                                      and failed attempts' backoff;
        #                                      the tuner/drift feedback wants
        #                                      the I/O itself. None under the
        #                                      simulator (modelled duration).
        self._telemetry_k: int = 0           # in-flight count on the device
        #                                      at launch (TelemetryHub)
        self.epoch = None                    # learning epoch membership
        self.retries = 0
        self.error: Optional[BaseException] = None
        self._ready_seq = -1                 # global readiness order (scheduler)
        self._sim_seq = -1                   # launch order (sim event queue)
        # sharded control plane (core.shardplane): owning shard and the
        # optional explicit routing anchor (``shard_key=`` call-time kwarg)
        self.shard = 0
        self.shard_key = None

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time

    @property
    def is_io(self) -> bool:
        return self.defn.task_type == TaskType.IO

    def future(self) -> Future:
        return self.futures[0]

    def __repr__(self) -> str:
        return f"<Task {self.defn.name}#{self.tid} {self.state.value}>"


def resolved_future(value: Any = None, name: str = "resolved") -> Future:
    """A Future that is already resolved to ``value``, backed by a DONE
    task that never entered any graph. Used where an operation short-
    circuits (e.g. a drain/prefetch that is already satisfied per the data
    catalog): downstream tasks may depend on it — the DONE producer
    satisfies the edge immediately."""
    inst = TaskInstance(TaskDef(fn=lambda: value, name=name), (), {})
    inst.state = TaskState.DONE
    fut = inst.futures[0]
    fut.set_value(value)
    return fut


class Barrier:
    """Completion latch used by wait_on / runtime barrier (real backend)."""

    def __init__(self):
        self._event = threading.Event()

    def release(self):
        self._event.set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)
