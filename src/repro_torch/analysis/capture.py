"""Capture mode: record the task DAG without executing it.

:class:`CaptureBackend` is a :class:`~repro.core.backends.Backend` that
never launches anything. The runtime detects it (``rt.capture_mode``) and
routes submissions past the scheduler entirely: every
:class:`~repro.core.task.TaskInstance` is recorded in a
:class:`PlanCapture` together with its *full* happens-before relation —
computed by :func:`repro.core.graph.compute_deps` *before*
``TaskGraph.add`` mutates the DataHandle bookkeeping, so edges to
already-completed producers (which ``add`` elides as satisfied) are kept.
``drain`` resolves futures to ``None`` in dependency-respecting
submission order so ``wait_on``/barriers return and the driving script
runs to completion; no task body, scheduler grant, or device accounting
ever executes.

The lint CLI (``python -m repro.lint``) sets :data:`FORCE` so that every
``IORuntime`` a script constructs — whatever backend it asked for — is
hijacked into capture mode and registered here for post-run analysis.
"""
from __future__ import annotations

import heapq
import threading

from ..core.backends import Backend
from ..core.graph import compute_deps, iter_futures
from ..core.task import TaskInstance, TaskState

#: when True (set by the repro.lint CLI), every IORuntime construction is
#: forced into capture mode regardless of the backend the script passed
FORCE = False

_registry_lock = threading.Lock()
_registry: list = []  # capture-mode runtimes constructed while FORCE was on


def set_force(on: bool) -> None:
    global FORCE
    FORCE = bool(on)


def register(runtime) -> None:
    with _registry_lock:
        _registry.append(runtime)


def registered() -> list:
    with _registry_lock:
        return list(_registry)


def clear_registry() -> None:
    with _registry_lock:
        _registry.clear()


class PlanCapture:
    """The recorded plan: tasks in submission order, the full
    happens-before relation, and the lifecycle events (pin/unpin/discard/
    external registrations) the lint rules reason about.

    Every record carries a monotonically increasing sequence number on one
    shared axis (``TaskInstance._plan_seq`` for tasks), so "submitted after
    the discard" style ordering questions are a plain comparison.
    """

    def __init__(self):
        self.tasks: list[TaskInstance] = []        # submission order
        #: consumer tid -> {producer tid: is_data} (full relation, including
        #: edges to producers that were already DONE at submission)
        self.edges: dict[int, dict[int, bool]] = {}
        #: consumer tid -> producer tids consumed through argument Futures
        #: (the data actually read — excludes DataHandle/anti ordering)
        self.future_inputs: dict[int, set[int]] = {}
        #: id(future) -> future for pins with no matching unpin yet
        self.pins: dict[int, object] = {}
        #: (seq, producer tid) for every rt.discard call
        self.discards: list[tuple[int, int]] = []
        #: external datasets: dicts with name/size_mb/tier/pinned/seq
        self.externals: list[dict] = []
        self._seq = 0

    def next_seq(self) -> int:
        self._seq += 1
        return self._seq

    # ------------------------------------------------------------- recording
    def on_submit(self, task: TaskInstance) -> None:
        """Record a submission. MUST run before ``TaskGraph.add`` — dep
        computation reads the DataHandle state ``add`` is about to bump."""
        task._plan_seq = self.next_seq()
        self.edges[task.tid] = {d.tid: is_data
                                for d, is_data in compute_deps(task).items()}
        futs: set[int] = set()
        for arg in list(task.args) + list(task.kwargs.values()):
            for f in iter_futures(arg):
                futs.add(f.task.tid)
        self.future_inputs[task.tid] = futs
        self.tasks.append(task)

    def on_pin(self, fut) -> None:
        self.next_seq()
        self.pins[id(fut)] = fut

    def on_unpin(self, fut) -> None:
        self.next_seq()
        self.pins.pop(id(fut), None)

    def on_discard(self, fut) -> None:
        self.discards.append((self.next_seq(), fut.task.tid))

    def on_external(self, name: str, size_mb: float, tier: str,
                    pinned: bool) -> None:
        self.externals.append({"name": name, "size_mb": float(size_mb),
                               "tier": tier, "pinned": bool(pinned),
                               "seq": self.next_seq()})


class CaptureBackend(Backend):
    """Backend that records the plan and executes nothing.

    ``launch`` raising (rather than passing) is the load-bearing guarantee
    behind "capture mode executes no task bodies": the runtime's capture
    submit path never reaches the scheduler, so nothing can call it.
    """

    is_capture = True

    def __init__(self):
        self.capture = PlanCapture()
        self._ready: list[tuple[int]] = []  # min-heap of ready tids

    def now(self) -> float:
        return 0.0

    def launch(self, task: TaskInstance, worker) -> None:
        raise AssertionError(
            "CaptureBackend.launch called — capture mode must never "
            "execute tasks (runtime submit-path bug)")

    def mark_ready(self, task: TaskInstance) -> None:
        heapq.heappush(self._ready, (task.tid,))

    def drain(self, predicate) -> None:
        """Resolve every captured task's futures to ``None`` in dependency-
        respecting tid order, so barriers and ``wait_on`` in the driving
        script return. ``sim_fail`` injections are ignored: the plan, not
        the failure semantics, is being recorded."""
        graph = self.runtime.graph
        while self._ready:
            (tid,) = heapq.heappop(self._ready)
            task = graph.tasks[tid]
            if task.state == TaskState.DONE:
                continue
            for f in task.futures:
                if not f.resolved():
                    f.set_value(None)
            for child in graph.complete(task):
                heapq.heappush(self._ready, (child.tid,))
        if not predicate():
            raise RuntimeError(
                f"capture drain resolved every recorded task but the wait "
                f"predicate still fails (unfinished={graph.unfinished}) — "
                f"a future from another runtime is being waited on here")
