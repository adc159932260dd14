"""IORuntime facade + PyCOMPSs-style decorators (paper Listings 1-5).

    from repro.core import task, io, constraint, IORuntime, INOUT

    @constraint(storageBW="auto")
    @io
    @task()
    def checkpoint(block, i):
        ...  # real write+fsync in RealBackend; modelled in SimBackend

    with IORuntime(cluster, backend=SimBackend()) as rt:
        for i in range(3):
            block = generate_block()          # returns a Future
            checkpoint(block, i, io_mb=290)   # overlaps with scale()
            results.append(scale(block))
        rt.barrier()

``io_mb=`` / ``duration=`` call-time kwargs feed the simulator's execution
model and are stripped before the user function sees its arguments.

Storage tiers
-------------
On a tiered cluster (``Cluster.make_tiered``: node-local SSD → shared burst
buffer → shared FS) an I/O task is placed on the fastest tier with budget by
default. Two hints pin it instead:

* ``@constraint(tier="bb")`` — every invocation targets the named tier;
* ``storage_tier="fs"`` at call time — per-invocation override, analogous
  to ``storage_bw=``.

Data moves *between* tiers through runtime-generated I/O tasks:
``rt.drain(fut, to_tier="fs", from_tier="ssd", io_mb=64)`` schedules an
asynchronous write-back (fast → slow) and ``rt.prefetch(...)`` the reverse;
both return Futures and overlap with compute like any other I/O task. Under
``RealBackend(tier_dirs={...})`` a ``path=`` names the file to copy between
the tier directories; under ``SimBackend`` the transfer is modelled with the
source tier's read floor and the destination tier's congestion.

``sim_fail=True`` at call time injects a failure at the task's simulated
completion (SimBackend only): the task FAILs and its data-descendants are
cancelled — the property-test harness drives fault-tolerance invariants
through this.
"""
from __future__ import annotations

import os
import shutil
import threading
from contextlib import contextmanager
from typing import Optional

from .autotune import DriftConfig
from .backends import Backend, RealBackend, SimBackend
from ..obs import TraceConfig, TraceRecorder
from .constraints import parse_storage_bw
from .datalife import DataCatalog, LifecycleConfig
from .failures import FailureEngine
from .interference import InterferenceEngine
from .graph import TaskGraph, _param_names
from .resources import Cluster
from .scheduler import Scheduler, eligible_devices
from .storage_model import read_floor_time
from .task import (Direction, Future, SimSpec, TaskDef, TaskInstance,
                   TaskState, TaskType, resolved_future)

_current: threading.local = threading.local()


def current_runtime() -> Optional["IORuntime"]:
    return getattr(_current, "rt", None)


#: call-time kwargs consumed by the runtime (see IORuntime docstring); a
#: wrapped function must not declare parameters with these names, because
#: the runtime strips them before the user function runs.
RESERVED_KWARGS = ("io_mb", "duration", "storage_bw", "storage_tier",
                   "sim_fail", "shard_key")


class TaskFunction:
    """A decorated function: direct call without a runtime, task submission
    inside a runtime context."""

    def __init__(self, defn: TaskDef):
        self.defn = defn
        self.__name__ = defn.name
        clashes = [n for n in RESERVED_KWARGS if n in _param_names(defn)]
        if clashes:
            raise TypeError(
                f"task {defn.name!r} declares reserved parameter(s) "
                f"{clashes}: {', '.join(RESERVED_KWARGS)} are runtime "
                f"execution-model kwargs and are stripped before the task "
                f"body runs — rename the function parameter(s)")

    def __call__(self, *args, **kwargs):
        rt = current_runtime()
        # strip exactly the names validated at decoration time — as
        # individual pops, not a dict build: this is the hottest line of
        # the submit path at the 1M-task bench scale
        pop = kwargs.pop
        raw_io_mb = pop("io_mb", None)
        raw_duration = pop("duration", None)
        bw_override = pop("storage_bw", None)
        storage_tier = pop("storage_tier", None)
        fail_spec = pop("sim_fail", None)
        shard_key = pop("shard_key", None)
        io_mb = float(raw_io_mb) if raw_io_mb else 0.0
        duration = float(raw_duration) if raw_duration else 0.0
        if io_mb < 0:
            raise ValueError(
                f"task {self.defn.name!r}: io_mb must be non-negative "
                f"(got {io_mb}) — it is the task's I/O footprint in MB")
        if duration < 0:
            raise ValueError(
                f"task {self.defn.name!r}: duration must be non-negative "
                f"(got {duration})")
        # booleans stay booleans (True: every attempt fails); an int N is
        # preserved so only the first N attempts fail — with maxRetries >= N
        # the task eventually succeeds (SimSpec.fail)
        if fail_spec is None or isinstance(fail_spec, bool):
            fail_spec = bool(fail_spec)
        else:
            fail_spec = int(fail_spec)
        sim = SimSpec(duration=duration, io_bytes=io_mb, fail=fail_spec)
        if rt is None:
            return self.defn.fn(*args, **kwargs)
        return rt.submit(self.defn, args, kwargs, sim,
                         storage_bw=parse_storage_bw(bw_override)
                         if bw_override is not None else None,
                         storage_tier=storage_tier,
                         shard_key=shard_key)


def _as_taskfn(fn) -> TaskFunction:
    if isinstance(fn, TaskFunction):
        return fn
    return TaskFunction(TaskDef(fn=fn, name=fn.__name__))


def task(returns: int = 0, **param_dirs):
    """@task(returns=1, data=INOUT) — declare a function as a task."""
    dirs = {}
    for name, d in param_dirs.items():
        if not isinstance(d, Direction):
            raise TypeError(f"direction for {name!r} must be IN/INOUT/OUT")
        dirs[name] = d

    def wrap(fn):
        tf = _as_taskfn(fn)
        tf.defn.returns = returns
        tf.defn.param_dirs.update(dirs)
        return tf
    return wrap


def io(fn):
    """@io — mark the task as an I/O task (zero computing units; scheduled on
    the I/O execution platform, overlapping compute tasks)."""
    tf = _as_taskfn(fn)
    tf.defn.task_type = TaskType.IO
    tf.defn.computing_units = 0
    return tf


def constraint(computingUnits: int | None = None, storageBW=None,
               maxRetries: int | None = None, tier: str | None = None):
    """@constraint(computingUnits=2) / @constraint(storageBW="auto(2,256,2)")
    / @constraint(tier="bb") — ``tier`` pins the task's I/O to the named
    storage tier (default: the fastest tier with budget, falling down the
    hierarchy)."""
    def wrap(fn):
        tf = _as_taskfn(fn)
        if computingUnits is not None:
            tf.defn.computing_units = int(computingUnits)
        if storageBW is not None:
            tf.defn.storage_bw = parse_storage_bw(storageBW)
        if maxRetries is not None:
            tf.defn.max_retries = int(maxRetries)
        if tier is not None:
            tf.defn.storage_tier = str(tier)
        return tf
    return wrap


def wait_on(*futures):
    """compss_wait_on: block until futures resolve; return their values."""
    rt = current_runtime()
    if rt is None:
        raise RuntimeError("wait_on outside an IORuntime context")
    return rt.wait_on(*futures)


# --------------------------------------------------------------------------
# Runtime-generated data movement between tiers (drain / prefetch)
# --------------------------------------------------------------------------
def copy_fsync(src_path, dst_path) -> str:
    """Durable copy: the write side is flushed and fsync'd before the call
    returns (the shared primitive under drain/prefetch movers and the
    checkpoint manager's shard drains)."""
    os.makedirs(os.path.dirname(dst_path) or ".", exist_ok=True)
    with open(src_path, "rb") as s, open(dst_path, "wb") as d:
        shutil.copyfileobj(s, d)
        d.flush()
        os.fsync(d.fileno())
    return str(dst_path)


def _make_mover(name: str) -> TaskFunction:
    """One I/O task signature per movement direction, so each gets its own
    placement class and (if auto-constrained) its own per-tier tuner."""
    def _move(data, src_path, dst_path):
        # RealBackend: copy+fsync between tier directories when both paths
        # resolved; SimBackend never executes this body — the transfer is
        # modelled (write side: destination device congestion; read side:
        # the source tier's read floor as the task's minimum duration).
        if src_path and dst_path:
            return copy_fsync(src_path, dst_path)
        return data
    _move.__name__ = name
    # movers are the durability path (eviction drains, emergency re-drains):
    # a transient device failure must not strand an object undurable
    return constraint(maxRetries=2)(io(task(returns=1)(_move)))


_drain_task = _make_mover("tier_drain")
_prefetch_task = _make_mover("tier_prefetch")


def _make_recovery_task() -> TaskFunction:
    """Lineage re-run: when a device failure orphans an object (every copy
    lost), the runtime re-executes the producer's work under this synthetic
    signature with the producer's recorded execution model (duration,
    io_mb). SimBackend never runs the body; under RealBackend lineage
    recovery is bookkeeping-only (DataObject carries no path)."""
    def _recover(inputs):
        return inputs
    _recover.__name__ = "lineage_recover"
    return constraint(maxRetries=2)(io(task(returns=1)(_recover)))


_recover_task = _make_recovery_task()


class IORuntime:
    """Master runtime: submission, dependency tracking, barriers, stats.

    Reserved call-time kwargs — ``io_mb=``, ``duration=`` and
    ``storage_bw=`` are consumed by the runtime itself (simulator execution
    model and per-call constraint override) and never reach the task body;
    decorating a function whose signature declares one of these names raises
    ``TypeError`` at decoration time.

    ``scheduler_cls`` exists for A/B comparisons (e.g. the frozen seed
    scheduler in ``benchmarks/_seed_impl.py``); it must match the
    ``Scheduler`` interface.

    Data lifecycle (``lifecycle=``, see datalife.py): when any tier carries
    a finite ``capacity_gb`` (or ``LifecycleConfig(enabled=True)``), every
    I/O task's output becomes a tracked ``DataObject``, tier capacity is
    reserved at grant and committed at finish, watermark/demand pressure on
    a fast tier synthesizes eviction tasks (drain-then-delete of cold
    objects), and tasks whose tracked inputs live only on a slower tier get
    an automatic ``rt.prefetch`` staged in front of them (the CkIO read
    pipeline) — including consumers submitted before their producer
    finished, via a conditional mover decided at the producer's completion
    (``pipeline_prefetch``). ``rt.discard(fut)`` marks temp data ephemeral
    so eviction deletes it without the durable drain. With no finite
    capacity the subsystem is inert and the runtime behaves exactly as
    before.

    Co-tenant interference (``interference=``, see interference.py and
    docs/interference.md): background traffic models injected into shared-
    tier devices (SimBackend only). ``drift=DriftConfig(...)`` arms the
    autotuners with a stale-curve detector that re-enters calibration on
    the live device; ``tier_objective=True`` turns the fastest-with-budget
    walk for tier-agnostic auto tasks into a measured argmin over the
    learned per-tier T(n, c) curves, priced with forced-eviction drains.
    All three default off and leave behaviour bit-identical.
    """

    def __init__(self, cluster: Cluster, backend: Backend | str = "sim",
                 scheduler_cls=Scheduler,
                 lifecycle: Optional[LifecycleConfig] = None,
                 interference=None,
                 failures=None,
                 drift: Optional[DriftConfig] = None,
                 tier_objective: bool = False,
                 trace=False,
                 shards: int = 1):
        self.cluster = cluster
        self.n_shards = int(shards)
        # constructor config, replayed by rt.plan() to build the capture
        # sibling with the same lifecycle/interference/tuning setup
        self._plan_config = dict(scheduler_cls=scheduler_cls,
                                 lifecycle=lifecycle,
                                 interference=interference,
                                 failures=failures, drift=drift,
                                 tier_objective=tier_objective,
                                 shards=shards)
        if isinstance(backend, str):
            if backend == "capture":
                from ..analysis.capture import CaptureBackend  # lazy: cycle
                backend = CaptureBackend()
            elif backend == "sim":
                backend = SimBackend()
            else:
                backend = RealBackend()
        # forced capture (the repro.lint CLI): whatever backend the script
        # asked for is replaced by a recording one — no task body executes
        from ..analysis import capture as _capture
        forced = _capture.FORCE and not getattr(backend, "is_capture", False)
        if forced:
            backend = _capture.CaptureBackend()
        self.capture_mode = bool(getattr(backend, "is_capture", False))
        # forced backend substitution (the repro.compare CLI): the
        # sim-vs-real harness runs the same unmodified script once under
        # SimBackend and once under RealBackend(tier_dirs=). Capture wins —
        # a lint pass must never execute task bodies.
        from .. import obs as _obs
        self._backend_forced = False
        if _obs.FORCE_BACKEND is not None and not self.capture_mode:
            forced_be = _obs.FORCE_BACKEND(cluster, backend)
            if forced_be is not None and forced_be is not backend:
                backend = forced_be
                self._backend_forced = True
        self.backend = backend
        self.lock = threading.RLock()
        self.graph = TaskGraph()
        # sharded control plane (shardplane.py, docs/scale.md): shards > 1
        # partitions the workers into per-shard schedulers behind the
        # ShardedScheduler facade; shards == 1 keeps the plain Scheduler —
        # zero facade overhead, bit-identical to every prior release
        if self.n_shards > 1:
            from .shardplane import ShardedScheduler  # lazy: rarely taken
            self.scheduler = ShardedScheduler(
                cluster, launch=self.backend.launch,
                n_shards=self.n_shards, scheduler_cls=scheduler_cls)
            self.graph.track_shards = True
        else:
            self.scheduler = scheduler_cls(cluster,
                                           launch=self.backend.launch)
        if drift is not None or tier_objective:
            set_tuning = getattr(self.scheduler, "set_tuning", None)
            if set_tuning is not None:
                set_tuning(drift=drift, tier_objective=tier_objective)
        # observability (obs/, docs/observability.md): trace=True (or a
        # TraceConfig / prebuilt TraceRecorder) wires a recorder into every
        # event site; None leaves each site a single is-not-None check away
        # from doing nothing (bit-identical behaviour either way). The
        # repro.trace CLI forces tracing on via obs.FORCE — same hijack
        # pattern as forced capture above. Capture mode never traces:
        # nothing executes, so there is nothing to time. Constructed BEFORE
        # the engines attach so t=0 bursts/health transitions are recorded.
        obs_forced = _obs.FORCE and not self.capture_mode
        if obs_forced and not trace:
            trace = True
        self.recorder = None
        if trace and not self.capture_mode:
            if isinstance(trace, TraceRecorder):
                rec = trace
            else:
                cfg = trace if isinstance(trace, TraceConfig) else None
                rec = TraceRecorder(cfg)
            rec.bind(clock=self.backend.now, scheduler=self.scheduler)
            self.recorder = rec
            set_recorder = getattr(self.scheduler, "set_recorder", None)
            if set_recorder is not None:
                set_recorder(rec)
        # co-tenant interference (interference.py): an InterferenceEngine,
        # or an iterable of (tier-or-device, TrafficModel) pairs. Simulation
        # only — a real cluster injects its own co-tenants.
        self.interference = None
        if interference is not None:
            engine = interference if isinstance(interference,
                                                InterferenceEngine) \
                else InterferenceEngine(list(interference), cluster)
            if engine.active:
                if self.capture_mode:
                    # recorded for the analyzer (IO401 reads the bindings);
                    # never attached — capture injects no traffic
                    self.interference = engine
                elif not isinstance(backend, SimBackend):
                    if not self._backend_forced:
                        raise ValueError(
                            "interference injection models co-tenant "
                            "traffic in the simulator; it is not supported "
                            f"on {type(backend).__name__}")
                    # forced substitution (repro.compare): injected
                    # co-tenants only exist in the simulator — the measured
                    # leg sees the real machine's own traffic instead, so
                    # the engine is dropped rather than refusing the run
                else:
                    engine.recorder = self.recorder  # before t=0 bursts
                    backend.attach_interference(engine)
                    self.interference = engine
        # plan() replays the *resolved* engine (an iterable argument was
        # consumed above; None when inactive, which has nothing to analyze)
        self._plan_config["interference"] = self.interference
        # tier failure domains (failures.py): a FailureEngine, a
        # FailureSchedule, or an iterable of (t, target, state[, bw_factor])
        # events. Simulation only — a real cluster fails on its own.
        self.failures = None
        if failures is not None:
            feng = failures if isinstance(failures, FailureEngine) \
                else FailureEngine(failures, cluster)
            if feng.active:
                if self.capture_mode:
                    # recorded for the analyzer (IO501 reads the schedule);
                    # never attached — capture flips no device health
                    self.failures = feng
                elif not isinstance(backend, SimBackend):
                    if not self._backend_forced:
                        raise ValueError(
                            "failure injection drives device health in the "
                            "simulator; it is not supported on "
                            f"{type(backend).__name__}")
                    # forced substitution (repro.compare): dropped, like
                    # the interference engine above
                else:
                    feng.recorder = self.recorder  # before t=0 transitions
                    backend.attach_failures(feng)
                    self.failures = feng
        self._plan_config["failures"] = self.failures
        # capture mode constructs non-strict: lifecycle config errors are
        # recorded (diagnostic IO204) instead of raising, so a plan a live
        # runtime would refuse can still be analyzed
        self.catalog = DataCatalog(cluster, lifecycle, now=self.backend.now,
                                   strict=not self.capture_mode)
        self.catalog.graph = self.graph
        if self.catalog.enabled and not self.capture_mode:
            set_catalog = getattr(self.scheduler, "set_catalog", None)
            if set_catalog is not None:
                set_catalog(self.catalog)
        if self.recorder is not None:
            self.catalog.recorder = self.recorder
        self._in_tick = False
        self._recovering = {}  # oid -> in-flight lineage-recovery Future
        self.backend.bind(self)
        self._entered = False
        if forced:
            _capture.register(self)  # the CLI lints every hijacked runtime
        if obs_forced:
            _obs.register(self)  # the CLI summarizes every traced runtime

    # ---------------------------------------------------------------- context
    def __enter__(self):
        _current.rt = self
        self._entered = True
        return self

    def __exit__(self, exc_type, exc, tb):
        try:
            if exc_type is None:
                self.barrier(final=True)
        finally:
            _current.rt = None
            self.backend.shutdown()
        return False

    # ------------------------------------------------------------- submission
    def submit(self, defn: TaskDef, args, kwargs, sim: SimSpec,
               storage_bw=None, storage_tier=None, shard_key=None):
        with self.lock:
            if self.capture_mode:
                # record-only path: no staging, no constraint validation
                # (unsatisfiable classes become IO1xx diagnostics instead of
                # raises), no scheduler, no lifecycle bookkeeping. The
                # capture hook runs BEFORE graph.add so the full
                # happens-before relation — including edges to already-DONE
                # producers, which add elides — is kept for the analyzer.
                inst = TaskInstance(defn, args, kwargs, sim=sim,
                                    storage_bw=storage_bw,
                                    storage_tier=storage_tier)
                if shard_key is not None:
                    inst.shard_key = shard_key  # lint reads routing anchors
                inst.submit_time = 0.0
                self.backend.capture.on_submit(inst)
                ready = self.graph.add(inst)
                if ready and inst.state != TaskState.FAILED:
                    self.backend.mark_ready(inst)
                if defn.returns > 1:
                    return tuple(inst.futures)
                return inst.futures[0]
            args, kwargs = self._stage_inputs(defn, args, kwargs,
                                              storage_tier)
            inst = TaskInstance(defn, args, kwargs, sim=sim,
                                storage_bw=storage_bw,
                                storage_tier=storage_tier)
            if shard_key is not None:
                inst.shard_key = shard_key
            if self.n_shards > 1:
                # route once, at submission: the owning shard is fixed for
                # the task's lifetime (validate_submit below checks the
                # class against that shard's sub-cluster)
                inst.shard = self.scheduler.route(inst)
            # reject unsatisfiable constraint/tier classes HERE, before the
            # task enters the graph: the error surfaces at the call site and
            # no half-registered state (unfinished counts, dependents) is
            # left behind. (getattr: A/B scheduler_cls like the frozen seed
            # predates submission-time validation)
            validate = getattr(self.scheduler, "validate_submit", None)
            if validate is not None:
                validate(inst)
            inst.submit_time = self.backend.now()
            if self.recorder is not None:
                self.recorder.on_submit(inst)
            ready = self.graph.add(inst)
            if inst.state != TaskState.FAILED:
                # scheduled-reader tracking (LRU clock + eviction guard);
                # tasks cancelled at add never run, so they never register
                self.catalog.on_submit(inst)
            if ready:
                self.scheduler.make_ready(inst)
            self.backend.on_submitted()
            self._lifecycle_tick()
        if defn.returns > 1:
            return tuple(inst.futures)
        return inst.futures[0]

    def _stage_inputs(self, defn: TaskDef, args, kwargs, storage_tier):
        """CkIO-style auto-prefetch: any argument future whose tracked data
        object is resident only on tiers slower than this task's target
        placement is replaced by a staging ``rt.prefetch`` future (value
        passes through the mover unchanged), so the read comes from the
        fast tier and concurrent stagings pipeline ahead of the consumer
        wave. One staging serves every reader of the same object."""
        cat = self.catalog
        if not cat.enabled or not cat.config.auto_prefetch:
            return args, kwargs
        if defn.signature in ("tier_drain", "tier_prefetch",
                              "lineage_recover"):
            return args, kwargs  # movers/recovery move data; never staged
        order = cat.cluster.tier_names()
        target = storage_tier or defn.storage_tier or \
            (order[0] if order else None)
        if target is None:
            return args, kwargs

        def map_arg(a, depth=0):
            if isinstance(a, Future):
                obj = cat.lookup_future(a)
                if obj is not None and cat.wants_stage(obj, target):
                    pf = cat.staging_future(obj, target)
                    if pf is None:
                        src = obj.fastest_tier(cat.tier_rank)
                        pf = self.prefetch(a, to_tier=target, from_tier=src,
                                           io_mb=obj.size_mb)
                        cat.begin_stage(obj, target, pf)
                    return pf
                if obj is None and cat.config.pipeline_prefetch:
                    # producer pipelining: the input's producer has not
                    # finished, so where its output will live is unknown —
                    # chain a *conditional* staging onto the producer's
                    # completion (decided at registration; a useless mover
                    # is neutralized into a zero-cost pass-through)
                    pf = cat.deferred_stage_future(a, target)
                    if pf is None and cat.wants_deferred_stage(a, target):
                        pf = self.prefetch(a, to_tier=target,
                                           io_mb=a.task.sim.io_bytes)
                        cat.begin_deferred_stage(a, target, pf)
                    if pf is not None:
                        return pf
                return a
            if depth < 4:
                if isinstance(a, list):
                    return [map_arg(v, depth + 1) for v in a]
                if isinstance(a, tuple):
                    return tuple(map_arg(v, depth + 1) for v in a)
                if isinstance(a, dict):
                    return {k: map_arg(v, depth + 1) for k, v in a.items()}
            return a

        return (tuple(map_arg(a) for a in args),
                {k: map_arg(v) for k, v in kwargs.items()})

    # ------------------------------------------------------------- completion
    def _handle_completion(self, task: TaskInstance) -> None:
        # called by the backend (sim loop / worker thread under runtime lock)
        self.scheduler.on_complete(task)
        failed = task.state == TaskState.FAILED
        # lifecycle bookkeeping AFTER the scheduler committed/cancelled the
        # capacity reservation: residency registration, reader release,
        # stage/evict mover resolution
        self.catalog.on_task_done(task, failed=failed)
        tag = getattr(task, "_datalife", None)
        if tag is not None and tag[0] == "recover":
            obj = tag[1]
            self._recovering.pop(obj.oid, None)
            # a lineage re-run restores a copy, not necessarily durability:
            # chain the emergency re-drain if the durable tier still lacks one
            if not failed and not obj.ephemeral and \
                    self.catalog.durable_tier is not None and \
                    self.catalog.durable_tier not in obj.residency:
                self._issue_redrain(obj)
        if not failed:
            newly_ready = self.graph.complete(task)
            if newly_ready:
                self.scheduler.make_ready_many(newly_ready)
        else:
            # failed task leaves the graph and takes its (necessarily still
            # PENDING) data-descendants with it, so drain loops can't hang on
            # them; write-after-read successors are merely unblocked
            cancelled, newly_ready = self.graph.fail(task)
            for c in cancelled:
                self.catalog.on_task_done(c, failed=True)
            if newly_ready:
                self.scheduler.make_ready_many(newly_ready)
        self._lifecycle_tick()

    # -------------------------------------------------------- fault tolerance
    def _requeue_retry(self, task: TaskInstance) -> None:
        """Return a failed attempt to the ready queue (SimBackend retry
        path, mirroring RealBackend's in-worker loop): the scheduler
        releases the grant, placement state is wiped, and the task re-enters
        readiness as a *fresh* grant — attempt N+1 may land on a different
        device, constraint, or tier than attempt N. Called under the
        runtime lock."""
        self.scheduler.on_retry(task)
        task.worker = None
        task.device = None
        task.granted_bw = 0.0
        task.reserved_mb = 0.0
        task.read_penalty = 0.0
        task.epoch = None
        task.tuner_key = None
        task.error = None
        task.measured_duration = None
        task._telemetry_k = 0
        if task.tier is not None and \
                not eligible_devices(self.cluster, task.tier):
            # the pinned tier went entirely offline: fall back to
            # tier-agnostic placement so the retry can land on a survivor
            task.tier = None
        task.state = TaskState.READY
        self.scheduler.make_ready(task)

    def _on_health_change(self, offline) -> None:
        """Devices went offline (FailureEngine transition, SimBackend):
        drop the residencies that died with them and synthesize recovery
        work. Called under the runtime lock, after in-flight I/O on the
        dead devices has failed into the retry path."""
        cat = self.catalog
        if not cat.enabled:
            return
        for dev in offline:
            orphans, at_risk = cat.on_device_offline(dev)
            for obj in at_risk:
                self._issue_redrain(obj)
            for obj in orphans:
                self._recover_object(obj)

    def _issue_redrain(self, obj) -> None:
        """Emergency re-drain: the object's only durable copy died with its
        device but a surviving copy exists on a faster tier — write it back
        so the object is durable again. If the durable tier is entirely
        offline the drain queues until a recovery event (lint IO501 flags a
        schedule that kills it permanently)."""
        cat = self.catalog
        to_tier = cat.durable_tier
        if to_tier is None or to_tier in obj.residency or obj.recovering:
            return
        src = obj.fastest_tier(cat.tier_rank)
        if src is None:
            return
        obj.recovering = True
        fut = self.drain(None, to_tier=to_tier, from_tier=src,
                         io_mb=obj.size_mb)
        fut.task._datalife = ("redrain", obj)
        self.scheduler._dirty = True

    def _recover_object(self, obj):
        """Lineage re-run for an orphaned object (every copy lost): re-
        execute the producer's recorded work, recursively recovering any
        of its tracked inputs that are also gone. Ephemeral objects nobody
        will read again are dropped silently; objects with no recorded
        producer (externals) are unrecoverable and land in
        ``catalog.lost_objects``. Returns the in-flight recovery Future
        (deduplicated per object), or None."""
        cat = self.catalog
        fut = self._recovering.get(obj.oid)
        if fut is not None:
            return fut
        if obj.ephemeral and not obj.readers:
            return None  # rt.discard temp data: nothing worth re-running
        producer = self.graph.tasks.get(obj.producer_tid)
        if producer is None:
            # external dataset or untracked producer: lineage is gone
            cat.lost_objects.append(obj)
            return None
        deps = []
        for inp in cat.input_objects(producer):
            if inp.residency:
                continue  # a surviving copy feeds the re-run directly
            f = self._recover_object(inp)
            if f is not None:
                deps.append(f)
        tier = producer.tier
        if tier is not None and not eligible_devices(self.cluster, tier):
            tier = None  # the producer's tier died too: land anywhere alive
        obj.recovering = True
        sim = SimSpec(duration=producer.sim.duration, io_bytes=obj.size_mb)
        fut = self.submit(_recover_task.defn, (deps,), {}, sim,
                          storage_tier=tier)
        fut.task._datalife = ("recover", obj)
        self._recovering[obj.oid] = fut
        self.scheduler._dirty = True
        return fut

    # --------------------------------------------------------- data lifecycle
    def _lifecycle_tick(self) -> bool:
        """Run one eviction-planning pass: watermark pressure plus any
        capacity-blocked demand the scheduler reported. Objects with a
        durable copy are dropped immediately; the rest get drain-then-delete
        eviction tasks (``rt.drain`` to the durable tier). Returns True when
        any eviction was started — backends use this to retry placement
        before declaring the scheduler stuck."""
        cat = self.catalog
        if not cat.enabled or self._in_tick:
            return False
        self._in_tick = True
        try:
            demand = getattr(self.scheduler, "capacity_blocked", None)
            actions = cat.plan_evictions(demand)
            if demand:
                demand.clear()
            progress = False
            for act in actions:
                if act.drain_to is None:
                    cat.drop_now(act.obj, act.device)
                    progress = True
                else:
                    fut = self.drain(None, to_tier=act.drain_to,
                                     from_tier=act.device.tier,
                                     io_mb=act.obj.size_mb)
                    fut.task._datalife = ("evict", act.obj, act.device)
                    progress = True
            if progress:
                self.scheduler._dirty = True
            return progress
        finally:
            self._in_tick = False

    def external_data(self, name: str, size_mb: float, tier: str,
                      pinned: bool = False) -> Future:
        """Register a dataset that already lives on ``tier`` (e.g. input
        files on the parallel FS at t0 — the CkIO staging scenario) and
        return a resolved Future tracked by the catalog: tasks taking it as
        an argument get read penalties and auto-prefetch like any produced
        object."""
        if not self.catalog.enabled:
            raise RuntimeError(
                "external_data requires the data lifecycle subsystem: give "
                "a tier a finite capacity_gb or pass "
                "LifecycleConfig(enabled=True)")
        with self.lock:
            # capture: register without charging device capacity (the
            # analyzer reasons about footprints symbolically; a recording
            # run must leave shared device state untouched)
            obj = self.catalog.add_external(name, size_mb, tier,
                                            pinned=pinned,
                                            charge=not self.capture_mode)
            fut = resolved_future(value=name, name=f"external:{name}")
            self.catalog.map_future(fut, obj)
            if self.capture_mode:
                self.backend.capture.on_external(name, size_mb, tier, pinned)
        return fut

    def pin(self, fut) -> None:
        """Exempt the future's data object from eviction."""
        with self.lock:
            if self.capture_mode:
                self.backend.capture.on_pin(fut)
                return
            self.catalog.pin(fut)

    def unpin(self, fut) -> None:
        with self.lock:
            if self.capture_mode:
                self.backend.capture.on_unpin(fut)
                return
            self.catalog.unpin(fut)

    def discard(self, fut) -> None:
        """Ephemeral liveness signal: the future's tracked data object will
        never be read again, so eviction may delete it *without* the
        durable drain (no FS bandwidth spent writing temp data back on its
        way out). Scheduled readers already in the graph are still
        honoured. Discarding before the producer finishes defers the mark
        to registration."""
        if not self.catalog.enabled:
            raise RuntimeError(
                "discard requires the data lifecycle subsystem: give a tier "
                "a finite capacity_gb or pass LifecycleConfig(enabled=True)")
        with self.lock:
            if self.capture_mode:
                self.backend.capture.on_discard(fut)
                return
            self.catalog.discard(fut)

    # ----------------------------------------------------- tier data movement
    def drain(self, data, to_tier: str, from_tier: Optional[str] = None,
              io_mb: float = 0.0, storage_bw=None,
              path: Optional[str] = None) -> Future:
        """Asynchronously write ``data`` back to a slower tier (e.g. burst
        buffer → shared FS). Returns a Future; the movement is an ordinary
        I/O task that overlaps with compute. ``data`` may be a Future (the
        drain then depends on its producer). ``path`` names a file to copy
        between ``RealBackend.tier_dirs`` directories; ``storage_bw``
        optionally throttles the writer (static MB/s or "auto")."""
        return self._move(_drain_task, data, to_tier, from_tier, io_mb,
                          storage_bw, path)

    def prefetch(self, data, to_tier: str, from_tier: Optional[str] = None,
                 io_mb: float = 0.0, storage_bw=None,
                 path: Optional[str] = None) -> Future:
        """Asynchronously stage ``data`` up to a faster tier (e.g. shared
        FS → node-local SSD) ahead of the tasks that will read it."""
        return self._move(_prefetch_task, data, to_tier, from_tier, io_mb,
                          storage_bw, path)

    def _move(self, mover: TaskFunction, data, to_tier, from_tier, io_mb,
              storage_bw, path) -> Future:
        if io_mb is not None and float(io_mb) < 0:
            raise ValueError(
                f"{mover.defn.name}: io_mb must be non-negative "
                f"(got {io_mb}) — it is the movement's footprint in MB")
        # no-op short-circuits: a same-tier "move", or data the catalog
        # already knows to be resident at the destination, resolves
        # immediately instead of scheduling a zero-progress movement task.
        # A path= move is never short-circuited on residency alone: catalog
        # residency is modelled state, and skipping it would report a real
        # file as copied without copy_fsync ever running.
        if from_tier is not None and from_tier == to_tier:
            return data if isinstance(data, Future) else resolved_future(
                data, name=f"noop_{mover.defn.name}")
        if isinstance(data, Future) and self.catalog.enabled:
            obj = self.catalog.lookup_future(data)
            if obj is not None:
                if to_tier in obj.residency and path is None:
                    return data
                # the catalog knows the payload's true footprint: charge the
                # destination what residency registration will record, not
                # whatever io_mb the caller guessed (a mismatch would desync
                # used_mb from the resident-object sum and underflow on a
                # later eviction)
                io_mb = obj.size_mb
        # read-side floor: a single reader streams at most at the source
        # device's bandwidth (the write side is modelled/performed on the
        # destination tier the task is placed on)
        src = None
        if from_tier is not None:
            src = self.cluster.tier_spec(from_tier)
        elif self.cluster.workers:
            src = self.cluster.workers[0].storage  # default: fastest tier
        dur = read_floor_time(src, io_mb) if src is not None else 0.0
        src_path = dst_path = None
        if path is not None:
            tp = getattr(self.backend, "tier_path", None)
            if tp is not None:
                # a backend that moves real files must be able to resolve
                # both ends — a silent no-op copy would report a drain as
                # durable without having moved anything
                if from_tier is None:
                    raise ValueError(
                        "path= movement needs from_tier= to locate the "
                        "source file")
                src_path = tp(from_tier, path)
                dst_path = tp(to_tier, path)
                if src_path is None or dst_path is None:
                    missing = from_tier if src_path is None else to_tier
                    raise ValueError(
                        f"no tier_dirs directory mapped for tier "
                        f"{missing!r} (have: "
                        f"{sorted(self.backend.tier_dirs)})")
        # pin to the destination tier only when the cluster models it; on a
        # plain single-tier cluster the move still runs, tier-agnostically
        tier_hint = to_tier if self.cluster.has_tier(to_tier) else None
        # submit directly (not via TaskFunction.__call__) so runtime-
        # synthesized movers — eviction drains fired from a completion on a
        # backend worker thread — don't depend on the thread-local ambient
        # runtime being set
        sim = SimSpec(duration=dur, io_bytes=float(io_mb or 0.0))
        return self.submit(
            mover.defn, (data, src_path, dst_path), {}, sim,
            storage_bw=parse_storage_bw(storage_bw)
            if storage_bw is not None else None,
            storage_tier=tier_hint)

    # ------------------------------------------------------------------ waits
    def barrier(self, final: bool = False) -> None:
        if final:
            with self.lock:
                self.scheduler.end_of_stream()
        self.backend.drain(lambda: self.graph.unfinished == 0)

    def wait_on(self, *futures):
        self.backend.drain(lambda: all(f.resolved() for f in futures))
        vals = [f.value() for f in futures]
        return vals[0] if len(vals) == 1 else vals

    # --------------------------------------------------------------- analysis
    def lint(self) -> list:
        """Run the static I/O-plan analyzer (see docs/lint.md) over this
        runtime's recorded plan (capture mode) or live graph. Returns the
        ``Diagnostic`` list sorted by (code, tid); empty means clean."""
        from ..analysis.lint import lint_runtime  # lazy: import cycle
        return lint_runtime(self)

    @contextmanager
    def plan(self):
        """Capture-mode sibling: a second runtime over the same cluster and
        configuration whose backend records the task DAG without executing
        any task body (futures resolve to ``None``). While the block is
        active it is the ambient runtime, so the same driving code that
        feeds this runtime can be replayed against it::

            with rt.plan() as p:
                build_pipeline()          # decorators submit to p, not rt
            diags = p.lint()

        Device state and catalogs of the live runtime are untouched."""
        cfg = self._plan_config
        prt = IORuntime(self.cluster, backend="capture",
                        scheduler_cls=cfg["scheduler_cls"],
                        lifecycle=cfg["lifecycle"],
                        interference=cfg["interference"],
                        failures=cfg["failures"],
                        drift=cfg["drift"],
                        tier_objective=cfg["tier_objective"],
                        shards=cfg["shards"])
        prev = getattr(_current, "rt", None)
        _current.rt = prt
        try:
            yield prt
            prt.barrier(final=True)
        finally:
            _current.rt = prev

    def trace(self) -> Optional[TraceRecorder]:
        """The runtime's :class:`~repro.obs.TraceRecorder` when constructed
        with ``trace=True`` (None otherwise — callers guard)."""
        return self.recorder

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        done = self.scheduler.completed
        io_tasks = [t for t in done if t.is_io]
        out = {
            "makespan": self.backend.now(),
            "n_tasks": len(done),
            "n_io_tasks": len(io_tasks),
            "avg_io_task_time": (sum(t.duration for t in io_tasks) / len(io_tasks))
            if io_tasks else 0.0,
            "tuners": {s: t.summary() for s, t in self.scheduler.tuners.items()},
            # per-tier occupancy: one entry per distinct device in the
            # hierarchy (shared tiers appear once)
            "devices": {d.name: {"tier": d.tier,
                                 "bytes_written": d.bytes_written,
                                 "capacity_mb": d.capacity_mb,
                                 "used_mb": d.used_mb,
                                 "peak_occupancy_mb": d.peak_occupancy_mb}
                        for d in self.cluster.devices},
        }
        if getattr(self.scheduler, "n_shards", 1) > 1:
            # sharded control plane rollup: per-shard launch counts, bus
            # message counters, lease accounts. Present exactly when the
            # run was sharded — unsharded stats stay schema-identical.
            out["shards"] = self.scheduler.summary()
            out["shards"]["cross_shard_edges"] = self.graph.cross_shard_edges
            out["shards"]["local_edges"] = self.graph.local_edges
        if self.catalog.enabled:
            out["lifecycle"] = self.catalog.summary()
        if self.interference is not None:
            out["interference"] = self.interference.summary()
        if self.failures is not None:
            out["failures"] = self.failures.summary()
        be = self.backend
        if isinstance(be, SimBackend):
            out.update({
                "io_busy_time": be.io_busy_time,
                "compute_busy_time": be.compute_busy_time,
                "overlap_time": be.overlap_time,
                "total_io_mb": be.total_io_mb,
                "io_throughput_mbs": (be.total_io_mb / be.io_busy_time)
                if be.io_busy_time > 0 else 0.0,
                "peak_io_mbs": be.peak_io_mbs,
            })
        if self.recorder is not None:
            # attribution rollup; absent when tracing is off so untraced
            # stats stay schema-identical to pre-obs runs (golden parity)
            out["wait_states"] = self.recorder.wait_state_summary()
            hub = getattr(self.backend, "telemetry", None)
            if hub is not None:
                # measured-throughput rollup: present exactly when the run
                # was traced AND the backend measures (RealBackend carries
                # a TelemetryHub, the simulator does not) — sim stats stay
                # schema-identical with the telemetry wiring present
                out["telemetry"] = hub.summary()
        return out
