"""Execution backends.

:class:`SimBackend` — deterministic discrete-event simulator with a virtual
clock. Compute tasks take their declared ``sim.duration``; I/O tasks move
``sim.io_bytes`` MB through the congestion model of their device
(storage_model.py), with per-task rates recomputed at every arrival/departure
(piecewise-linear integration). Used by the paper-figure benchmarks and the
property tests — bit-for-bit reproducible.

:class:`RealBackend` — thread pools per worker (a compute platform sized to
``cpus`` and an I/O platform sized to ``io_executors``, paper Fig. 7), wall
clock, real user functions (real ``write``+``fsync`` for I/O tasks). Used by
the end-to-end training driver for async checkpointing.
"""
from __future__ import annotations

import heapq
import itertools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

from .scheduler import SchedulerError
from .storage_model import per_task_rate
from .task import Future, TaskInstance, TaskState, TaskType

_EPS = 1e-9


class Backend:
    """Interface the runtime drives."""

    #: trace recorder (obs/), picked up from the runtime at bind; None
    #: keeps every event site a single comparison away from doing nothing
    recorder = None

    def bind(self, runtime) -> None:
        self.runtime = runtime
        self.recorder = getattr(runtime, "recorder", None)

    def launch(self, task: TaskInstance, worker) -> None:
        raise NotImplementedError

    def drain(self, predicate: Callable[[], bool]) -> None:
        raise NotImplementedError

    def on_submitted(self) -> None:
        pass

    def now(self) -> float:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


# --------------------------------------------------------------------------
# Simulator
# --------------------------------------------------------------------------
class SimBackend(Backend):
    """Discrete-event simulator with an O(log n) event queue.

    Events live in a single lazy-deletion ``heapq``: each running task has at
    most one *current* entry (a per-tid version counter supersedes older
    ones). An entry's time is a lower-bound estimate of the task's true
    finish time — exact while the task's device keeps its I/O population, and
    an under-estimate after more streams join (rates only drop, so the true
    time moves later). When a stream *leaves* a device the per-task rate
    rises and old estimates would be late, so entries for that device are
    eagerly re-pushed — devices expose monotonically increasing epochs
    (resources.py): ``rate_epoch`` for any population change and
    ``release_epoch`` for rate-RAISING changes only; the refresh keys on the
    latter, because lower-bound estimates survive allocations unharmed.
    ``_next_event_time`` then pops candidates, recomputes
    their exact finish time at the current clock (the same arithmetic the
    per-event linear scan used, so results are bit-identical), and returns
    the minimum.
    """

    #: estimates within this window of the best candidate are recomputed
    #: exactly (covers float drift between push-time and pop-time arithmetic)
    _GUARD = 1e-9

    def __init__(self, sanitize: bool = False):
        self.clock = 0.0
        self._compute: dict[int, tuple[TaskInstance, float]] = {}  # tid -> (task, end)
        self._io: dict[int, list] = {}  # tid -> [task, remaining_mb, min_end]
        # co-tenant traffic (interference.py); None keeps every code path —
        # and all arithmetic — identical to the interference-free simulator
        self.interference = None
        # failure domains (failures.py); None (or an empty schedule) keeps
        # the simulator byte-identical to a failure-free run
        self.failures = None
        # IOSan (repro.analysis.sanitizer): event-boundary invariant checks.
        # All checks are pure reads, so sanitize=True leaves the launch log
        # bit-identical; None costs one comparison per loop iteration.
        self.sanitizer = None
        if sanitize:
            from ..analysis.sanitizer import IOSanitizer  # lazy: no cycle
            self.sanitizer = IOSanitizer()
        self.io_busy_time = 0.0         # union over devices of I/O activity
        self.compute_busy_time = 0.0
        self.overlap_time = 0.0         # time with BOTH compute and I/O active
        self.total_io_mb = 0.0
        self.peak_io_mbs = 0.0          # max sustained aggregate I/O rate
        # --- event queue state ---
        self._heap: list[tuple[float, int, int, int]] = []  # (est, seq, tid, ver)
        self._entry_ver: dict[int, int] = {}                # tid -> live version
        self._push_seq = itertools.count()
        self._launch_seq = itertools.count()                # seed-order pop ties
        self._dev_tasks: dict[int, tuple] = {}   # id(dev) -> (dev, set[tid])
        self._dev_epoch_seen: dict[int, int] = {}  # id(dev) -> release_epoch
        # sharded control plane (core.shardplane): one event heap per shard,
        # batch-scanned per event step so each shard's queue stays short.
        # bind() splits the heaps when the runtime's scheduler is sharded;
        # unsharded, _heaps[0] IS _heap (the same list object) and every
        # push/scan/pop runs the exact arithmetic above — launch logs stay
        # bit-identical.
        self._heaps: list[list] = [self._heap]
        self._tid_shard: Optional[dict[int, int]] = None  # tid -> shard

    def now(self) -> float:
        return self.clock

    def bind(self, runtime) -> None:
        super().bind(runtime)
        n = getattr(runtime.scheduler, "n_shards", 1)
        if n > 1:
            self._heaps = [[] for _ in range(n)]
            self._tid_shard = {}

    def attach_interference(self, engine) -> None:
        """Bind an InterferenceEngine: burst boundaries become simulation
        events, co-tenant streams join each device's congestion model."""
        self.interference = engine if engine is not None and engine.active \
            else None
        if self.interference is not None:
            # bursts starting at the current clock (t=0 co-tenants) must
            # hold their budgets before the first schedule pass runs
            self.interference.apply_due(self.clock)

    def attach_failures(self, engine) -> None:
        """Bind a FailureEngine: scheduled health transitions become
        simulation events, peer to the interference engine's bursts."""
        self.failures = engine if engine is not None and engine.active \
            else None
        if self.failures is not None:
            # t=0 events (a tier down from the start) take effect before
            # the first schedule pass; nothing is running or resident yet,
            # so the transitions need no reroute/re-drain handling
            self.failures.apply_due(self.clock)

    # ---------------------------------------------------------- event queue
    def _push_entry(self, tid: int, est: float) -> None:
        ver = self._entry_ver.get(tid, 0) + 1
        self._entry_ver[tid] = ver
        heap = self._heap if self._tid_shard is None \
            else self._heaps[self._tid_shard[tid]]
        heapq.heappush(heap, (est, next(self._push_seq), tid, ver))

    def _true_finish(self, rec: list) -> float:
        task, rem, min_end = rec
        dev = task.device or task.worker.storage
        # co-tenant streams share the device fairly (0 without interference:
        # the arithmetic — and thus the golden launch log — is unchanged)
        rate = per_task_rate(dev, dev.active_io + dev.background_streams)
        eta = self.clock + rem / rate if rate > 0 else float("inf")
        return max(eta, min_end)

    def _refresh_stale_devices(self) -> None:
        """Re-push estimates for every task on a device whose per-task rate
        *rose* since the last check (lazy deletion leaves the superseded
        entries to be skipped on pop).

        Only releases raise rates — per-task rate is non-increasing in the
        stream count — and only a rate rise can turn an existing lower-bound
        estimate stale-late, so allocations (launch bursts) cost nothing
        here: their entries are merely early and get tightened lazily."""
        for dev_id, (dev, tids) in self._dev_tasks.items():
            if not tids:
                continue
            if self._dev_epoch_seen.get(dev_id) == dev.release_epoch:
                continue
            self._dev_epoch_seen[dev_id] = dev.release_epoch
            # one rate per device (all its tasks share the fair-share rate);
            # same arithmetic as _true_finish, hoisted out of the tid loop.
            # _push_entry is inlined below — this loop re-keys every task
            # of every stale device and is the single largest source of
            # heap pushes at the 1M-task bench scale
            rate = per_task_rate(dev, dev.active_io + dev.background_streams)
            clock = self.clock
            io = self._io
            ver_map = self._entry_ver
            push_seq = self._push_seq
            tid_shard = self._tid_shard
            heaps = self._heaps
            heappush = heapq.heappush
            inf = float("inf")
            for tid in tids:
                if rate > 0:
                    rec = io[tid]
                    est = clock + rec[1] / rate
                    min_end = rec[2]
                    if est < min_end:
                        est = min_end
                else:
                    est = inf
                ver = ver_map.get(tid, 0) + 1
                ver_map[tid] = ver
                heap = heaps[0] if tid_shard is None \
                    else heaps[tid_shard[tid]]
                heappush(heap, (est, next(push_seq), tid, ver))

    def launch(self, task: TaskInstance, worker) -> None:
        task.start_time = self.clock
        task._sim_seq = next(self._launch_seq)
        if self._tid_shard is not None:
            self._tid_shard[task.tid] = task.shard
        if self.sanitizer is not None:
            self.sanitizer.record(
                "launch", t=self.clock, tid=task.tid,
                sig=task.defn.signature, worker=worker.name,
                device=task.device.name if task.device is not None else None)
        if self.recorder is not None:
            self.recorder.on_launch(task, worker)
        # read_penalty: the data-lifecycle catalog's simulated cost of
        # pulling tracked inputs from their fastest resident tier (0.0
        # unless the lifecycle subsystem is active — grant-time snapshot)
        dur = task.sim.duration + task.read_penalty
        if task.defn.task_type == TaskType.COMPUTE:
            end = self.clock + max(dur, _EPS)
            self._compute[task.tid] = (task, end)
            self._push_entry(task.tid, end)
        else:
            rem = max(task.sim.io_bytes, 0.0)
            min_end = self.clock + max(dur, _EPS)
            rec = [task, rem, min_end]
            self._io[task.tid] = rec
            # the device the scheduler granted (a tier of the worker); falls
            # back to the worker's primary device for bare/legacy launches
            dev = task.device or worker.storage
            entry = self._dev_tasks.get(id(dev))
            if entry is None:
                entry = self._dev_tasks[id(dev)] = (dev, set())
            entry[1].add(task.tid)
            self._push_entry(task.tid, self._true_finish(rec))

    def _next_event_time(self) -> float:
        best = float("inf")
        for heap in self._heaps:
            t = self._scan_heap(heap)
            if t < best:
                best = t
        return best

    def _scan_heap(self, heap: list) -> float:
        """Exact next event time within one shard's heap (the whole queue,
        unsharded). The global next event is the min across shards — each
        scan pops candidates within ``_GUARD`` of its own best, recomputes
        their true finish at the current clock, and re-pushes."""
        ver = self._entry_ver
        best = float("inf")
        repush = []
        # same once-per-device rate cache as _advance_to: the scan is pure
        # reads, so every candidate on one device sees one fair-share rate
        rates: dict[int, float] = {}
        clock = self.clock
        while heap:
            est, _, tid, v = heap[0]
            if est > best + self._GUARD:
                break
            heapq.heappop(heap)
            if ver.get(tid) != v:
                continue  # superseded or finished: lazy deletion
            if tid in self._compute:
                true = self._compute[tid][1]
            elif tid in self._io:
                task, rem, min_end = self._io[tid]
                dev = task.device or task.worker.storage
                key = id(dev)
                rate = rates.get(key)
                if rate is None:
                    rate = rates[key] = per_task_rate(
                        dev, dev.active_io + dev.background_streams)
                # inlined _true_finish with the cached rate
                eta = clock + rem / rate if rate > 0 else float("inf")
                true = eta if eta > min_end else min_end
            else:
                continue
            if true < best:
                best = true
            repush.append((true, tid))
        for true, tid in repush:
            self._push_entry(tid, true)
        return best

    def _advance_to(self, t: float) -> None:
        dt = t - self.clock
        if dt <= 0:
            self.clock = t
            return
        io_active = bool(self._io)
        comp_active = bool(self._compute)
        if io_active:
            self.io_busy_time += dt
        if comp_active:
            self.compute_busy_time += dt
        if io_active and comp_active:
            self.overlap_time += dt
        interval_mb = 0.0
        # per-device fair-share rate, computed once per event instead of
        # once per in-flight record: device stream counts are constant for
        # the whole interval, so the cached float is the exact value
        # per_task_rate would return for every record on that device
        rates: dict[int, float] = {}
        for rec in self._io.values():
            task, rem, _ = rec
            dev = task.device or task.worker.storage
            key = id(dev)
            rate = rates.get(key)
            if rate is None:
                rate = rates[key] = per_task_rate(
                    dev, dev.active_io + dev.background_streams)
            moved = min(rem, rate * dt)
            rec[1] = rem - moved
            dev.bytes_written += moved
            self.total_io_mb += moved
            interval_mb += moved
            if rec[1] <= 1e-6 < rem:
                # transfer finished off its own event (float ties): from here
                # the task's exact finish is its min_end — re-key its entry
                self._push_entry(task.tid, max(t, rec[2]))
        if dt > 1e-6 and interval_mb > 0:
            self.peak_io_mbs = max(self.peak_io_mbs, interval_mb / dt)
        self.clock = t

    def _finish_io(self, tid: int) -> TaskInstance:
        task, _, _ = self._io.pop(tid)
        self._entry_ver.pop(tid, None)
        if self._tid_shard is not None:
            self._tid_shard.pop(tid, None)
        dev = task.device or task.worker.storage
        self._dev_tasks[id(dev)][1].discard(tid)
        return task

    def _pop_due(self) -> list[TaskInstance]:
        due_c: list[TaskInstance] = []
        due_io: list[TaskInstance] = []
        repush: list[tuple[int, float]] = []
        horizon = self.clock + _EPS
        for heap in self._heaps:
            self._pop_due_heap(heap, horizon, due_c, due_io, repush)
        # re-push AFTER draining the horizon: a tightened estimate can land
        # back inside it (fast devices: rem in MB vs horizon in seconds) and
        # re-pushing inside the loop would pop it again forever
        for tid, est in repush:
            self._push_entry(tid, est)
        # the seed popped compute tasks then I/O tasks, each in launch order
        # (the per-shard batches merge into the same global order: _sim_seq
        # is assigned from one counter at launch)
        due_c.sort(key=lambda t: t._sim_seq)
        due_io.sort(key=lambda t: t._sim_seq)
        return due_c + due_io

    def _pop_due_heap(self, heap: list, horizon: float,
                      due_c: list, due_io: list, repush: list) -> None:
        """Drain one shard's heap up to ``horizon`` into the shared due
        batches (the whole event queue, unsharded)."""
        ver = self._entry_ver
        while heap and heap[0][0] <= horizon:
            _, _, tid, v = heapq.heappop(heap)
            if ver.get(tid) != v:
                continue
            if tid in self._compute:
                task, end = self._compute[tid]
                if end <= horizon:
                    del self._compute[tid]
                    del ver[tid]
                    if self._tid_shard is not None:
                        self._tid_shard.pop(tid, None)
                    due_c.append(task)
                else:  # defensive: estimate undershot the fixed end
                    repush.append((tid, end))
            elif tid in self._io:
                rec = self._io[tid]
                if rec[1] <= 1e-6 and rec[2] <= horizon:
                    due_io.append(self._finish_io(tid))
                else:  # estimate was early (device gained streams): tighten
                    repush.append((tid, self._true_finish(rec)))

    # ------------------------------------------------------ failure domains
    def _fail_attempt(self, task: TaskInstance, error: BaseException) -> bool:
        """One attempt of ``task`` failed (injected fault or its device went
        offline). While attempts remain (``maxRetries``, same arithmetic as
        RealBackend._run: ``max_retries + 1`` attempts, ``task.retries``
        counting failed ones) the task re-enters the ready queue for a
        fresh grant — on a surviving eligible device — and True is
        returned; otherwise the task is FAILED and False is returned (the
        caller resolves futures and hands it to the runtime)."""
        task.retries += 1
        if task.retries <= task.defn.max_retries:
            if self.sanitizer is not None:
                self.sanitizer.record(
                    "retry", t=self.clock, tid=task.tid,
                    sig=task.defn.signature, attempt=task.retries)
            if self.recorder is not None:
                self.recorder.on_retry(task)
            self.runtime._requeue_retry(task)
            return True
        task.state = TaskState.FAILED
        if task.error is None:
            task.error = error
        return False

    def _on_failure_transitions(self, transitions) -> None:
        """Health transitions just fired: fail in-flight I/O on newly
        offline devices into the retry path, then let the runtime drop
        lost residencies and synthesize re-drains/lineage recovery."""
        rt = self.runtime
        san = self.sanitizer
        offline = []
        for dev, prev, new in transitions:
            if san is not None:
                san.record("health", t=self.clock, device=dev.name,
                           prev=prev, state=new)
            if new == "offline" and prev != "offline":
                offline.append(dev)
        for dev in offline:
            entry = self._dev_tasks.get(id(dev))
            if entry is None or not entry[1]:
                continue
            # deterministic order: launch order, like _pop_due
            tids = sorted(entry[1], key=lambda tid: self._io[tid][0]._sim_seq)
            for tid in tids:
                task = self._finish_io(tid)
                task.end_time = self.clock
                err = RuntimeError(
                    f"device {dev.name} went offline under "
                    f"{task.defn.name}#{task.tid}")
                if self._fail_attempt(task, err):
                    continue
                if self.recorder is not None:
                    self.recorder.on_complete(task, failed=True)
                for f in task.futures:
                    f.set_value(None)
                rt._handle_completion(task)
        if offline:
            rt._on_health_change(offline)
        rt.scheduler._dirty = True
        self._refresh_stale_devices()

    #: in the nothing-running branch, at most this many consecutive burst
    #: boundaries are stepped through looking for one that unblocks a grant
    #: before the scheduler is declared stuck (bounds the wait on infinite
    #: burst trains when the blockage is unrelated to interference)
    _BG_STUCK_LIMIT = 512

    def _bg_step(self, eng) -> bool:
        """Advance the clock to the next co-tenant burst boundary and apply
        it (nothing of ours is running). Returns True when a boundary was
        applied — a burst end releases bandwidth/capacity that may unblock
        a ready task; a burst start can push a tier over its watermark and
        let the lifecycle tick make eviction progress."""
        t = eng.next_time()
        if t == float("inf"):
            return False
        if t > self.clock:
            self._advance_to(t)
        eng.apply_due(self.clock)
        if self.recorder is not None:
            self.recorder.on_stall(self.clock, "bg_step")
        self._refresh_stale_devices()
        self.runtime.scheduler._dirty = True
        self.runtime._lifecycle_tick()
        return True

    def _fail_step(self, feng) -> bool:
        """Advance to the next scheduled health transition and apply it
        (nothing of ours is running): a recovery can make a pinned tier's
        devices eligible again and unblock the queued class."""
        t = feng.next_time()
        if t == float("inf"):
            return False
        if t > self.clock:
            self._advance_to(t)
        transitions = feng.apply_due(self.clock)
        if transitions:
            self._on_failure_transitions(transitions)
        if self.recorder is not None:
            self.recorder.on_stall(self.clock, "fail_step")
        self._refresh_stale_devices()
        self.runtime.scheduler._dirty = True
        self.runtime._lifecycle_tick()
        return True

    def drain(self, predicate: Callable[[], bool]) -> None:
        rt = self.runtime
        eng = self.interference
        feng = self.failures
        bg_retries = 0
        san = self.sanitizer
        while True:
            if rt.scheduler.schedule_pass():
                bg_retries = 0
            # no refresh needed here: launches only allocate (rates drop),
            # which leaves existing estimates as valid lower bounds
            if san is not None:
                san.check(self)  # event boundary: after grants, before step
            if predicate():
                return
            if not self._compute and not self._io:
                # nothing running: either stalled learning epochs or done
                if rt.scheduler.n_ready:
                    # a capacity-blocked task may just need an eviction —
                    # give the lifecycle a chance before declaring stuck
                    if rt._lifecycle_tick():
                        continue
                    # gentle unstick first (close partial learning epochs
                    # and retry — the interference-free behaviour); only if
                    # that still leaves nothing placeable may a co-tenant
                    # burst be holding the budget/capacity: step to the
                    # next burst boundary and try again
                    try:
                        rt.scheduler.assert_not_stuck()
                    except SchedulerError:
                        if bg_retries < self._BG_STUCK_LIMIT and (
                                (eng is not None and self._bg_step(eng))
                                or (feng is not None
                                    and self._fail_step(feng))):
                            bg_retries += 1
                            continue
                        raise
                    continue
                if predicate():
                    return
                raise SchedulerError(
                    f"simulation drained but predicate unmet "
                    f"(unfinished={rt.graph.unfinished})")
            bg_retries = 0
            t = self._next_event_time()
            if eng is not None:
                t = min(t, eng.next_time())
            if feng is not None:
                t = min(t, feng.next_time())
            if t == float("inf"):
                raise SchedulerError("no next event with tasks running")
            self._advance_to(t)
            for task in self._pop_due():
                task.end_time = self.clock
                fail_spec = task.sim.fail
                # sim_fail=True fails every attempt; sim_fail=N only the
                # first N (task.retries counts failed attempts so far)
                inject = fail_spec is True or \
                    (fail_spec and task.retries < int(fail_spec))
                if san is not None:
                    san.record("complete", t=self.clock, tid=task.tid,
                               sig=task.defn.signature,
                               failed=bool(inject))
                if inject:
                    # fault injection (sim_fail= at call time): the task
                    # consumed its resources and time, then this attempt
                    # FAILs — retried under maxRetries exactly like
                    # RealBackend (a re-placement is a fresh grant); once
                    # attempts are exhausted the runtime cancels its
                    # data-descendants. Non-raising: post-mortem inspection
                    # happens via graph states.
                    if self._fail_attempt(task, RuntimeError(
                            f"injected failure: "
                            f"{task.defn.name}#{task.tid}")):
                        continue
                if self.recorder is not None:
                    self.recorder.on_complete(task, failed=bool(inject))
                for f in task.futures:
                    f.set_value(None)
                rt._handle_completion(task)
            if eng is not None and eng.apply_due(self.clock):
                # burst boundaries at this instant: budgets/rates changed —
                # retry placement, and let a capacity burst that crossed a
                # watermark trigger eviction planning
                rt.scheduler._dirty = True
                rt._lifecycle_tick()
            if feng is not None:
                # health transitions at this instant: completions at t won
                # the tie (a task that finishes as its device dies counts
                # as finished), then in-flight work on dead devices fails
                # into the retry path and the catalog starts recovery
                transitions = feng.apply_due(self.clock)
                if transitions:
                    self._on_failure_transitions(transitions)
                    rt._lifecycle_tick()
            self._refresh_stale_devices()  # releases raised device rates
            if san is not None:
                san.check(self)  # event boundary: completions + bursts done


# --------------------------------------------------------------------------
# Real (threaded) backend
# --------------------------------------------------------------------------
class RealBackend(Backend):
    """Threaded backend. ``tier_dirs`` maps tier labels to directories
    (e.g. ``{"ssd": "/nvme/scratch", "fs": "/gpfs/ckpt"}``) so runtime-
    generated drain/prefetch tasks can move files between tiers; see
    ``IORuntime.drain``/``IORuntime.prefetch``."""

    def __init__(self, poll_interval: float = 0.02,
                 tier_dirs: Optional[dict] = None):
        self._t0 = time.monotonic()
        self._pools: dict[tuple[str, str], ThreadPoolExecutor] = {}
        self._cv = threading.Condition()  # rebound to runtime.lock in bind()
        self._poll = poll_interval
        self._failed: list[TaskInstance] = []
        self.tier_dirs = dict(tier_dirs) if tier_dirs else {}
        # measured per-device throughput (obs/telemetry.py): fed on every
        # I/O launch/complete; always collecting (cheap — one dict/deque
        # update per op), emitted as trace events only when the run is
        # traced. The simulator has no hub, which is what gates the
        # stats()["telemetry"] key to real runs.
        from ..obs.telemetry import TelemetryHub  # lazy: obs pulls nothing
        #                                           from core, but keep the
        #                                           import edge one-way
        self.telemetry = TelemetryHub()

    def tier_path(self, tier: str, name: str) -> Optional[str]:
        """Absolute path of ``name`` inside ``tier``'s directory, or None
        when the tier has no directory mapping."""
        base = self.tier_dirs.get(tier)
        if base is None:
            return None
        return os.path.join(str(base), name)

    def bind(self, runtime) -> None:
        super().bind(runtime)
        # validate tier_dirs keys against the cluster's actual tier labels
        # up front: an unknown key used to be silently ignored and surfaced
        # much later as a confusing per-task "no tier_dirs directory" error.
        # Only enforced when the cluster models a hierarchy — on a single-
        # tier cluster the labels are plain directory names for tier-
        # agnostic path= movement, not modelled tiers.
        tiers = runtime.cluster.tier_names()
        unknown = sorted(k for k in self.tier_dirs
                         if not runtime.cluster.has_tier(k))
        if unknown and len(tiers) > 1:
            raise ValueError(
                f"RealBackend tier_dirs key(s) {unknown} name no storage "
                f"tier in the cluster (tiers: "
                f"{runtime.cluster.tier_names()}) — a path= drain/prefetch "
                f"targeting them could never resolve its endpoint")
        self._cv = threading.Condition(runtime.lock)
        self.telemetry.bind(self.recorder)

    def now(self) -> float:
        return time.monotonic() - self._t0

    def _pool(self, worker, platform: str) -> ThreadPoolExecutor:
        key = (worker.name, platform)
        if key not in self._pools:
            size = worker.cpus if platform == "compute" else worker.io_executors
            self._pools[key] = ThreadPoolExecutor(
                max_workers=max(1, size),
                thread_name_prefix=f"{worker.name}-{platform}")
        return self._pools[key]

    @staticmethod
    def _resolve(arg, _depth=0):
        if isinstance(arg, Future):
            return arg.value()
        if _depth < 4:
            if isinstance(arg, list):
                return [RealBackend._resolve(v, _depth + 1) for v in arg]
            if isinstance(arg, tuple):
                return tuple(RealBackend._resolve(v, _depth + 1) for v in arg)
            if isinstance(arg, dict):
                return {k: RealBackend._resolve(v, _depth + 1)
                        for k, v in arg.items()}
        return arg

    def launch(self, task: TaskInstance, worker) -> None:
        platform = "compute" if task.defn.task_type == TaskType.COMPUTE else "io"
        task.start_time = self.now()
        if task.defn.task_type == TaskType.IO and task.device is not None:
            # launch-side concurrency snapshot: the fit harness groups
            # samples by the depth the op ran under (launch is always under
            # the runtime lock — submit/schedule_pass hold it)
            task._telemetry_k = self.telemetry.on_launch(
                task.start_time, task.device)
        if self.recorder is not None:
            self.recorder.on_launch(task, worker)
        self._pool(worker, platform).submit(self._run, task)

    def _run(self, task: TaskInstance) -> None:
        args = tuple(self._resolve(a) for a in task.args)
        kwargs = {k: self._resolve(v) for k, v in task.kwargs.items()}
        err: Optional[BaseException] = None
        result = None
        attempts = task.defn.max_retries + 1
        for attempt in range(attempts):
            attempt_t0 = time.monotonic()
            try:
                result = task.defn.fn(*args, **kwargs)
                # measured wall time of the successful attempt alone: the
                # signal the drift monitor compares against the learned
                # curve (task.duration would also count pool queueing,
                # argument resolution and earlier attempts' backoff)
                task.measured_duration = time.monotonic() - attempt_t0
                err = None
                break
            except BaseException as e:  # noqa: BLE001 — report at barrier
                err = e
                task.retries = attempt + 1
                if attempt + 1 < attempts:
                    time.sleep(min(0.05 * (2 ** attempt), 1.0))
        task.end_time = self.now()
        if err is not None:
            task.error = err
            task.state = TaskState.FAILED
        if task.defn.returns > 1 and isinstance(result, tuple):
            for f, v in zip(task.futures, result):
                f.set_value(v)
        else:
            task.futures[0].set_value(result)
        with self._cv:
            if task.defn.task_type == TaskType.IO and task.device is not None:
                # measured sample under the runtime lock (same critical
                # section as the complete event, so trace order matches)
                self.telemetry.on_complete(
                    task.end_time, task.device, task.sim.io_bytes,
                    task.measured_duration, failed=task.error is not None,
                    launch_inflight=task._telemetry_k)
            if self.recorder is not None:
                # RealBackend retries in-place inside this worker thread, so
                # a failed attempt never re-enters the ready queue — the
                # whole retry loop lands in this one complete event
                self.recorder.on_complete(task, failed=task.error is not None)
            self.runtime._handle_completion(task)
            if task.error is not None:
                self._failed.append(task)
            self._cv.notify_all()

    def on_submitted(self) -> None:
        with self._cv:
            self.runtime.scheduler.schedule_pass()

    def drain(self, predicate: Callable[[], bool]) -> None:
        rt = self.runtime
        with self._cv:
            while True:
                rt.scheduler.schedule_pass()
                if self._failed:
                    t = self._failed[0]
                    raise RuntimeError(
                        f"task {t.defn.name}#{t.tid} failed after "
                        f"{t.retries} attempt(s)") from t.error
                if predicate():
                    return
                if not rt.scheduler.running and rt.scheduler.n_ready:
                    if rt._lifecycle_tick():
                        continue
                    rt.scheduler.assert_not_stuck()
                    continue
                self._cv.wait(timeout=self._poll)

    def shutdown(self) -> None:
        for p in self._pools.values():
            p.shutdown(wait=True)
        self._pools.clear()
