"""repro.core — the paper's contribution: an I/O-aware task runtime.

Public API (PyCOMPSs-flavoured, paper §4):
    @task(returns=..., param=INOUT)   declare a task
    @io                                mark it an I/O task (overlaps compute)
    @constraint(storageBW=...)         static / "auto" / "auto(min,max,delta)"
    IORuntime(cluster, backend)        master runtime (sim or real backend)
    wait_on(fut)                       compss_wait_on
"""
from .autotune import DriftConfig
from .backends import RealBackend, SimBackend
from .constraints import AutoSpec, StaticSpec, parse_storage_bw
from .datalife import (DataCatalog, DataObject, EvictionPolicy,
                       LifecycleConfig, LRUEviction, TierCapacity)
from .failures import FailureEngine, FailureEvent, FailureSchedule
from .interference import (Burst, BurstyTraffic, ConstantTraffic,
                           InterferenceEngine, TraceTraffic, TrafficModel)
from .resources import Cluster, StorageDevice, WorkerNode
from .runtime import IORuntime, constraint, current_runtime, io, task, wait_on
from .scheduler import SchedulerError
from .storage_model import (aggregate_throughput, cross_tier_time,
                            expected_task_time, max_concurrent_tasks,
                            per_task_rate, read_floor_time)
from .task import IN, INOUT, OUT, DataHandle, Direction, Future, TaskState

# analysis itself imports the core submodules above, so its names are
# re-exported lazily (PEP 562) — an eager import here would be circular
# whenever repro.analysis is the import entry point (the lint CLI).
_ANALYSIS_EXPORTS = ("CaptureBackend", "Diagnostic", "IOSanitizer",
                     "SanitizerError")


def __getattr__(name):
    if name in _ANALYSIS_EXPORTS:
        from .. import analysis
        return getattr(analysis, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CaptureBackend", "Diagnostic", "IOSanitizer", "SanitizerError",
    "task", "io", "constraint", "wait_on", "IORuntime", "current_runtime",
    "SimBackend", "RealBackend", "Cluster", "WorkerNode", "StorageDevice",
    "AutoSpec", "StaticSpec", "parse_storage_bw", "SchedulerError",
    "IN", "INOUT", "OUT", "Direction", "DataHandle", "Future", "TaskState",
    "DataCatalog", "DataObject", "EvictionPolicy", "LifecycleConfig",
    "LRUEviction", "TierCapacity",
    "Burst", "BurstyTraffic", "ConstantTraffic", "DriftConfig",
    "InterferenceEngine", "TraceTraffic", "TrafficModel",
    "FailureEngine", "FailureEvent", "FailureSchedule",
    "aggregate_throughput", "per_task_rate", "expected_task_time",
    "max_concurrent_tasks", "cross_tier_time", "read_floor_time",
]
