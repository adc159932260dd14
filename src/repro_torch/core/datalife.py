"""Data lifecycle subsystem: object residency, tier capacity, eviction,
auto-prefetch.

The paper's I/O-aware scheduler (§4.2) constrains storage *bandwidth*; this
module adds the second finite resource of a tiered hierarchy — *capacity*.
Fast tiers (node-local SSD, burst buffer) are small: a 240 GB SSD cannot
"fit" an unbounded stream of checkpoint shards no matter how well bandwidth
is budgeted. The subsystem closes the loop the related work sketches:

* **CkIO (arXiv:2411.18593)** — read staging: input files are prefetched
  from the parallel FS into fast storage ahead of the compute wave, so reads
  hit the fast tier. Here the scheduler *auto-issues* ``rt.prefetch`` tasks
  for any task whose tracked inputs are resident only on a slower tier than
  its target placement — the CkIO read pipeline without user annotations.
* **Aupy et al. (arXiv:1702.06900)** — periodic I/O under burst-buffer
  capacity pressure: when a fast tier crosses its high watermark the catalog
  synthesizes *eviction* tasks (drain-then-delete of cold objects, LRU by
  last reader, pinned objects exempt) that write cold data back to the
  durable tier in the shadow of compute, keeping the fast tier absorbing new
  bursts.

Concept map
-----------
``DataObject``
    Every I/O task's output (``io_mb`` footprint) becomes a tracked object
    with *per-tier residency*: which tiers hold a copy, on which concrete
    device (per-worker SSDs are distinct devices of one tier). External
    datasets (already on the parallel FS at t0, the CkIO input case) enter
    via :meth:`DataCatalog.add_external`.
``TierCapacity``
    Per-tier capacity/watermark spec. ``StorageDevice.capacity_gb`` carries
    the budget; occupancy is accounted like the bandwidth epochs —
    *reserve at grant, commit at finish* — so concurrent writers can never
    overcommit a tier (resources.py).
``EvictionPolicy`` / ``LRUEviction``
    Chooses victims among resident objects that are not pinned, have no
    scheduled reader, and are not already being evicted. Objects without a
    durable copy are drained first (``rt.drain`` machinery, runtime.py) and
    deleted only after the drain lands — *every evicted object keeps a
    durable copy*.
``DataCatalog``
    The bookkeeping hub: registers outputs, tracks readers (LRU clock),
    plans evictions from watermark pressure *and* demand (a capacity-blocked
    grant reported by the scheduler), computes read penalties (the simulated
    cost of pulling inputs from their fastest resident tier), and brokers
    staging futures so one prefetch serves many readers.

The subsystem is **inert by default**: with no finite ``capacity_gb``
anywhere (and no explicit ``LifecycleConfig(enabled=True)``) the catalog
stays disabled and the scheduler/simulator behave bit-identically to the
capacity-less implementation — the golden-parity suite pins this.

Pipelined prefetch: a consumer submitted *before* its producer finishes
cannot know where the output will land, so it gets a **conditional**
staging — a mover chained onto the producer's completion whose decision is
made at registration time (``pipeline_prefetch``): if the output landed on
a slower tier than the consumer's target, the mover becomes a real staging;
otherwise it is neutralized into a zero-cost pass-through. Ephemeral
objects (``rt.discard``): temp data provably never read again is deleted at
eviction without the durable drain, freeing FS bandwidth.

Limitations: under ``RealBackend`` eviction drains move catalog state, not
files, since ``DataObject`` carries no path — file movement stays with
``rt.drain(path=)`` and the checkpoint manager.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional

from .resources import Cluster, StorageDevice
from .storage_model import read_floor_time
from .task import TaskInstance, TaskState, TaskType


def _validate_watermark(name: str, value: float) -> None:
    if not (0.0 < value <= 1.0):
        raise ValueError(
            f"{name} must be a fraction in (0, 1], got {value}")


@dataclass(frozen=True)
class TierCapacity:
    """Capacity/watermark spec for one tier.

    ``capacity_gb`` (if given) is applied to every device of the tier when
    the catalog binds to a cluster; ``high_watermark`` is the occupancy
    fraction that triggers eviction, which then drains down to
    ``low_watermark``.
    """

    tier: str
    capacity_gb: Optional[float] = None
    high_watermark: float = 0.85
    low_watermark: float = 0.60

    def __post_init__(self):
        if self.capacity_gb is not None and self.capacity_gb <= 0:
            raise ValueError(
                f"tier {self.tier!r}: capacity_gb must be positive, got "
                f"{self.capacity_gb}")
        _validate_watermark(f"tier {self.tier!r}: high_watermark",
                            self.high_watermark)
        _validate_watermark(f"tier {self.tier!r}: low_watermark",
                            self.low_watermark)
        if self.low_watermark > self.high_watermark:
            raise ValueError(
                f"tier {self.tier!r}: low_watermark ({self.low_watermark}) "
                f"must not exceed high_watermark ({self.high_watermark})")


class DataObject:
    """A tracked datum resident on one or more storage tiers."""

    _ids = itertools.count()

    def __init__(self, name: str, size_mb: float, producer_tid: int = -1,
                 pinned: bool = False, created: float = 0.0):
        self.oid = next(DataObject._ids)
        self.name = name
        self.size_mb = float(size_mb)
        self.producer_tid = producer_tid
        self.pinned = pinned
        self.created = created
        self.last_use = created        # LRU clock: bumped by reader activity
        self.ephemeral = False         # rt.discard: never read again, so
        #                                eviction may delete without a drain
        self.residency: dict[str, StorageDevice] = {}  # tier -> device copy
        self.readers: set[int] = set()  # tids of scheduled/running readers
        self.reader_log: list[list] = []  # [tid, submit_t, end_t|None]
        self._open_reads: dict[int, list] = {}  # tid -> its open log record
        self.staging: dict[str, object] = {}  # tier -> in-flight prefetch fut
        self.evicting: bool = False
        self.recovering: bool = False  # failure recovery in flight (redrain
        #                                or lineage re-run): exempt from
        #                                eviction until the copy lands

    def begin_read(self, tid: int, t: float) -> None:
        self.readers.add(tid)
        if tid not in self._open_reads:  # O(1); a tid reads an object once
            rec = [tid, t, None]
            self.reader_log.append(rec)
            self._open_reads[tid] = rec
        self.last_use = t

    def end_read(self, tid: int, t: float) -> None:
        self.readers.discard(tid)
        rec = self._open_reads.pop(tid, None)
        if rec is not None:
            rec[2] = t
        self.last_use = t

    def fastest_tier(self, rank: Callable[[str], int]) -> Optional[str]:
        if not self.residency:
            return None
        return min(self.residency, key=rank)

    def __repr__(self) -> str:
        return (f"<DataObject {self.name}#{self.oid} {self.size_mb:.0f}MB "
                f"on {sorted(self.residency)}>")


class EvictionPolicy:
    """Victim selection among evictable resident objects of one device."""

    def select(self, candidates: list[DataObject], need_mb: float
               ) -> list[DataObject]:
        raise NotImplementedError


class LRUEviction(EvictionPolicy):
    """Coldest-first by last reader time (ties: oldest object first)."""

    def select(self, candidates: list[DataObject], need_mb: float
               ) -> list[DataObject]:
        chosen, freed = [], 0.0
        for obj in sorted(candidates, key=lambda o: (o.last_use, o.oid)):
            if freed >= need_mb:
                break
            chosen.append(obj)
            freed += obj.size_mb
        return chosen


@dataclass
class LifecycleConfig:
    """Runtime-level configuration of the data lifecycle subsystem.

    ``enabled=None`` auto-detects: the subsystem activates iff any device in
    the cluster has a finite ``capacity_gb`` (or a ``tiers`` entry supplies
    one). ``durable_tier`` names the backing store evictions drain to;
    default is the slowest tier of the hierarchy. Objects resident on the
    durable tier are never evicted from it.
    """

    enabled: Optional[bool] = None
    auto_prefetch: bool = True
    #: extend auto_prefetch to fully-async DAGs: a consumer submitted before
    #: its producer finishes gets a conditional staging chained onto the
    #: producer's completion (decided when the output's tier is known)
    #: instead of silently skipping staging. Only meaningful with
    #: auto_prefetch on.
    pipeline_prefetch: bool = True
    auto_evict: bool = True
    high_watermark: float = 0.85
    low_watermark: float = 0.60
    durable_tier: Optional[str] = None
    policy: EvictionPolicy = field(default_factory=LRUEviction)
    tiers: dict = field(default_factory=dict)  # tier -> TierCapacity

    def __post_init__(self):
        _validate_watermark("high_watermark", self.high_watermark)
        _validate_watermark("low_watermark", self.low_watermark)
        if self.low_watermark > self.high_watermark:
            raise ValueError(
                f"low_watermark ({self.low_watermark}) must not exceed "
                f"high_watermark ({self.high_watermark})")
        for tier, tc in self.tiers.items():
            if not isinstance(tc, TierCapacity):
                raise TypeError(
                    f"tiers[{tier!r}] must be a TierCapacity, got "
                    f"{type(tc).__name__}")


@dataclass
class EvictionAction:
    """One planned eviction: free ``obj``'s copy on ``device``; if the
    object has no durable copy yet, drain it to ``drain_to`` first."""

    obj: DataObject
    device: StorageDevice
    drain_to: Optional[str]  # None: durable copy exists, drop immediately


class DataCatalog:
    """Residency + capacity bookkeeping for every tracked data object.

    Owned by the runtime; the scheduler holds a reference for grant-time
    hooks (read penalties, demand reporting). All methods are called under
    the runtime lock.
    """

    def __init__(self, cluster: Cluster, config: Optional[LifecycleConfig],
                 now: Callable[[], float], strict: bool = True):
        self.cluster = cluster
        self.config = config or LifecycleConfig()
        self.now = now
        # strict=False (capture mode, repro.analysis): configuration errors
        # are recorded here instead of raising, so the static analyzer can
        # report them as diagnostics (IO204) over a plan that a live
        # runtime would refuse to construct
        self.config_errors: list[str] = []
        # trace recorder (obs/): wired by the runtime when tracing is on;
        # None costs one comparison per lifecycle event
        self.recorder = None
        # sharded control plane (core.shardplane): the ShardedScheduler
        # wires its bus here so every residency change is ALSO posted as an
        # ordered broadcast message. The mutation itself stays synchronous
        # (applied before the message is posted, never partially): eviction
        # planning and read-penalty snapshots run between bus drains and
        # must see current occupancy — the message stream is the ordered
        # cross-shard record, not the mechanism of the update.
        self.shardbus = None
        self._tier_order = cluster.tier_names()
        self._rank = {t: i for i, t in enumerate(self._tier_order)}
        # apply TierCapacity budgets before auto-detection
        for tc in self.config.tiers.values():
            if tc.capacity_gb is None:
                continue
            for dev in cluster.devices:
                if dev.tier == tc.tier:
                    dev.capacity_gb = tc.capacity_gb
        if self.config.enabled is None:
            self.enabled = any(d.capacity_gb is not None
                               for d in cluster.devices)
        else:
            self.enabled = bool(self.config.enabled)
        self.durable_tier = self.config.durable_tier or (
            self._tier_order[-1] if self._tier_order else None)
        if self.enabled and self.config.auto_evict:
            # eviction drains land on the durable tier and objects there are
            # never evicted, so a finite durable tier would silently wedge
            # once cumulative output exceeds it (capacity-blocked drains,
            # nothing evictable) — fail loudly up front instead
            finite = [d.name for d in cluster.devices
                      if d.tier == self.durable_tier
                      and d.capacity_gb is not None]
            if finite:
                msg = (
                    f"durable tier {self.durable_tier!r} must be unlimited "
                    f"when auto_evict is on (eviction drains terminate "
                    f"there and are never themselves evicted), but "
                    f"{finite} carry capacity_gb — drop the budget, pick "
                    f"another durable_tier, or set "
                    f"LifecycleConfig(auto_evict=False)")
                if strict:
                    raise ValueError(msg)
                self.config_errors.append(msg)
        # capacities are fixed once the runtime is constructed: precompute
        # the finite devices so the per-submission/per-completion lifecycle
        # tick doesn't rescan workers x tiers (0-3 entries in practice)
        self._finite_devs = [d for d in cluster.devices
                             if d.capacity_mb is not None]
        self.graph = None  # TaskGraph, wired by the runtime: lets output
        #                    registration pick up readers that were submitted
        #                    before the producer finished (pipelined DAGs)
        self.objects: dict[int, DataObject] = {}
        # id(Future) -> (future, object): the future itself is retained so a
        # garbage-collected future's reused id can never resolve to a stale
        # object (external/resolved futures are not held by the graph)
        self._by_fut: dict[int, tuple] = {}
        self._pending_pins: set[int] = set()         # pinned-before-produced
        self._pending_discards: set[int] = set()     # discarded-before-produced
        self._resident: dict[int, set] = {}          # id(device) -> objects
        self._evicting_mb: dict[int, float] = {}     # id(device) -> in-flight
        # pipelined prefetch: consumers submitted before their producer
        # finished register a *deferred* staging decision here, resolved at
        # the producer's registration — id(producer_fut) -> (fut, {tier:
        # mover_fut}); the future is retained so a reused id can't alias
        self._deferred_stage: dict[int, tuple] = {}
        self.events: list[dict] = []                 # eviction audit log
        self.lost_objects: list[DataObject] = []     # unrecoverable after a
        #                                              device failure (no
        #                                              copy, no lineage)
        self.n_prefetches = 0
        self.n_evictions = 0
        self.n_discards = 0
        self.n_deferred_stages = 0
        self.bytes_evicted_mb = 0.0
        self.bytes_prefetched_mb = 0.0

    # ------------------------------------------------------------- helpers
    def tier_rank(self, tier: str) -> int:
        return self._rank.get(tier, len(self._rank))

    def _watermarks(self, dev: StorageDevice) -> tuple[float, float]:
        tc = self.config.tiers.get(dev.tier)
        if tc is not None:
            return tc.high_watermark, tc.low_watermark
        return self.config.high_watermark, self.config.low_watermark

    #: public accessor (the scheduler's tier-choice objective prices the
    #: eviction drain a watermark crossing would force)
    watermarks = _watermarks

    def lookup_future(self, fut) -> Optional[DataObject]:
        entry = self._by_fut.get(id(fut))
        return entry[1] if entry is not None else None

    def map_future(self, fut, obj: DataObject) -> None:
        self._by_fut[id(fut)] = (fut, obj)

    def input_objects(self, task: TaskInstance) -> list[DataObject]:
        """Distinct tracked objects among a task's argument futures."""
        from .graph import iter_futures  # local: avoid import cycle
        out, seen = [], set()
        for arg in list(task.args) + list(task.kwargs.values()):
            for f in iter_futures(arg):
                obj = self.lookup_future(f)
                if obj is not None and obj.oid not in seen:
                    seen.add(obj.oid)
                    out.append(obj)
        return out

    def _shard_of(self, obj: DataObject) -> int:
        """Source shard of a residency message: the producing task's owner
        (external objects and pre-shard producers fall back to shard 0)."""
        if self.graph is not None:
            t = self.graph.tasks.get(obj.producer_tid)
            if t is not None:
                return t.shard
        return 0

    def _add_residency(self, obj: DataObject, dev: StorageDevice) -> None:
        obj.residency[dev.tier] = dev
        self._resident.setdefault(id(dev), set()).add(obj)
        if self.shardbus is not None:
            self.shardbus.post("RESIDENCY_ADD", self._shard_of(obj), None,
                               (obj.name, dev.tier))

    def _drop_residency(self, obj: DataObject, dev: StorageDevice) -> None:
        if obj.residency.get(dev.tier) is dev:
            del obj.residency[dev.tier]
        self._resident.get(id(dev), set()).discard(obj)
        if self.shardbus is not None:
            self.shardbus.post("RESIDENCY_DROP", self._shard_of(obj), None,
                               (obj.name, dev.tier))

    # ----------------------------------------------------------- ingestion
    def add_external(self, name: str, size_mb: float, tier: str,
                     pinned: bool = False, charge: bool = True
                     ) -> DataObject:
        """Register a dataset that already exists on ``tier`` at time zero
        (the CkIO input case: files on the parallel FS before the run).
        Commits capacity on the tier's representative device.
        ``charge=False`` (capture mode) registers residency without
        touching device accounting, keeping plan capture side-effect-free
        on a shared cluster object."""
        if size_mb <= 0:
            raise ValueError(f"external object {name!r}: size_mb must be "
                             f"positive, got {size_mb}")
        dev = self.cluster.tier_spec(tier)
        if dev is None:
            raise ValueError(
                f"external object {name!r}: tier {tier!r} not present "
                f"(available: {self._tier_order})")
        if dev.health == "offline":
            # prefer a surviving device of the tier over the representative
            dev = next((d for d in self.cluster.devices if d.tier == tier
                        and d.health != "offline"), dev)
        obj = DataObject(name, size_mb, pinned=pinned, created=self.now())
        if charge:
            if not dev.can_reserve_capacity(size_mb):
                raise ValueError(
                    f"external object {name!r} ({size_mb} MB) does not fit "
                    f"on {dev.name} ({dev.free_capacity_mb():.0f} MB free)")
            dev.reserve_capacity(size_mb)
            dev.commit_capacity(size_mb)
        self._add_residency(obj, dev)
        self.objects[obj.oid] = obj
        return obj

    def register_output(self, task: TaskInstance) -> Optional[DataObject]:
        """A successful I/O task's written bytes become a resident object on
        the device the write was granted on."""
        if task.device is None or task.sim.io_bytes <= 0:
            return None
        t = self.now()
        obj = DataObject(f"{task.defn.signature}#{task.tid}",
                         task.sim.io_bytes, producer_tid=task.tid,
                         created=t)
        self._add_residency(obj, task.device)
        self.objects[obj.oid] = obj
        for f in task.futures:
            self.map_future(f, obj)
            if id(f) in self._pending_pins:
                self._pending_pins.discard(id(f))
                obj.pinned = True
            if id(f) in self._pending_discards:
                self._pending_discards.discard(id(f))
                obj.ephemeral = True
        # readers submitted BEFORE the producer finished (pipelined DAGs)
        # could not be tracked at their submission — the object didn't exist
        # yet. Pick them up from the dependency graph now, so eviction can
        # never select an object a scheduled consumer is about to read.
        if self.graph is not None:
            from .graph import iter_futures  # local: avoid import cycle
            fut_ids = {id(f) for f in task.futures}
            for ctid in task.children:
                child = self.graph.tasks.get(ctid)
                if child is None or child.state in (TaskState.DONE,
                                                    TaskState.FAILED):
                    continue
                # only true data readers: anti-dependents (write-after-read
                # successors) are children too but never touch the object
                reads = any(id(f) in fut_ids for arg in
                            list(child.args) + list(child.kwargs.values())
                            for f in iter_futures(arg))
                if reads:
                    obj.begin_read(ctid, t)
        self._resolve_deferred(task, obj, t)
        return obj

    def pin(self, fut_or_obj) -> Optional[DataObject]:
        """Exempt from eviction. Pinning a future whose producer has not
        finished yet is allowed — the pin applies when the object
        registers."""
        obj = fut_or_obj if isinstance(fut_or_obj, DataObject) \
            else self.lookup_future(fut_or_obj)
        if obj is None:
            self._pending_pins.add(id(fut_or_obj))
            return None
        obj.pinned = True
        if self.recorder is not None:
            self.recorder.on_pin(self.now(), obj, True)
        return obj

    def unpin(self, fut_or_obj) -> Optional[DataObject]:
        obj = fut_or_obj if isinstance(fut_or_obj, DataObject) \
            else self.lookup_future(fut_or_obj)
        if obj is None:
            self._pending_pins.discard(id(fut_or_obj))
            return None
        obj.pinned = False
        if self.recorder is not None:
            self.recorder.on_pin(self.now(), obj, False)
        return obj

    def discard(self, fut_or_obj) -> Optional[DataObject]:
        """Ephemeral liveness signal (``rt.discard``): the caller promises
        the datum will never be read again. Eviction may then *delete* the
        object without the durable drain — temp data stops consuming FS
        bandwidth on its way out. Outstanding scheduled readers are still
        honoured (the evictable filter skips objects with readers).
        Discarding before the producer finished defers the mark to
        registration, like pin."""
        obj = fut_or_obj if isinstance(fut_or_obj, DataObject) \
            else self.lookup_future(fut_or_obj)
        if obj is None:
            self._pending_discards.add(id(fut_or_obj))
            return None
        obj.ephemeral = True
        return obj

    # -------------------------------------------------------- reader hooks
    def on_submit(self, task: TaskInstance) -> None:
        """Track the task as a scheduled reader of its tracked inputs: the
        LRU clock advances and eviction must not select these objects while
        the reader is outstanding."""
        if not self.enabled:
            return
        t = self.now()
        for obj in self.input_objects(task):
            obj.begin_read(task.tid, t)

    def on_grant(self, task: TaskInstance) -> None:
        """Grant-time hook from the scheduler: charge the simulated cost of
        pulling inputs from their fastest resident tier (movers carry their
        own read floor from ``IORuntime._move`` and are skipped)."""
        if not self.enabled:
            return
        if getattr(task, "_datalife", None) is not None or \
                task.defn.signature in ("tier_drain", "tier_prefetch"):
            return
        penalty = 0.0
        for obj in self.input_objects(task):
            tier = obj.fastest_tier(self.tier_rank)
            if tier is None:
                continue
            src = self.cluster.tier_spec(tier)
            if src is not None:
                penalty += read_floor_time(src, obj.size_mb)
        task.read_penalty = penalty

    def on_task_done(self, task: TaskInstance, failed: bool) -> None:
        """Completion hook (runtime, under lock, after the scheduler
        committed/cancelled the capacity reservation): close reader
        bookkeeping, resolve mover tags, register new outputs."""
        if not self.enabled:
            return
        t = self.now()
        in_objs = self.input_objects(task)
        for obj in in_objs:
            obj.end_read(task.tid, t)
        if failed:
            # a failed/cancelled producer never registers: its deferred
            # staging decisions die with it (the movers are its data-
            # descendants and were cancelled by the same fan-out)
            for f in task.futures:
                self._deferred_stage.pop(id(f), None)
        tag = getattr(task, "_datalife", None)
        if tag is not None:
            kind, obj = tag[0], tag[1]
            if kind == "stage":
                self._finish_stage(task, obj, tag[2], failed)
            elif kind == "evict":
                self._finish_evict(task, obj, tag[2], failed)
            elif kind in ("redrain", "recover"):
                self._finish_recovery(task, obj, failed)
            return
        if not failed and task.is_io and task.sim.io_bytes > 0 \
                and task.device is not None:
            if task.defn.signature in ("tier_drain", "tier_prefetch"):
                # a user-issued move of tracked data: the payload gains a
                # copy on the destination device, no new object is minted —
                # but only when the mover's accounted footprint matches the
                # object (a drain submitted before its producer registered
                # carries the caller's io_mb guess; recording the object's
                # true size against a commit of the guessed size would
                # desync used_mb from the resident sum and underflow later)
                if len(in_objs) == 1 and \
                        in_objs[0].size_mb == task.sim.io_bytes and \
                        in_objs[0].residency.get(task.device.tier) \
                        is not task.device:
                    obj = in_objs[0]
                    self._add_residency(obj, task.device)
                    for f in task.futures:  # mover future aliases the datum
                        self.map_future(f, obj)
                    return
            self.register_output(task)

    # ----------------------------------------------------------- prefetch
    def staging_future(self, obj: DataObject, tier: str):
        """The in-flight prefetch future for ``obj``→``tier``, if any —
        a second reader of the same cold object rides the same staging."""
        return obj.staging.get(tier)

    def begin_stage(self, obj: DataObject, tier: str, fut) -> None:
        obj.staging[tier] = fut
        self.map_future(fut, obj)
        fut.task._datalife = ("stage", obj, tier)
        self.n_prefetches += 1
        self.bytes_prefetched_mb += obj.size_mb
        if self.recorder is not None:
            self.recorder.on_stage(self.now(), obj, tier)

    def _finish_stage(self, task: TaskInstance, obj: DataObject, tier: str,
                      failed: bool) -> None:
        obj.staging.pop(tier, None)
        if not failed and task.device is not None:
            if obj.residency.get(task.device.tier) is task.device:
                # a lineage recovery (or competing mover) landed this copy
                # while the stage was in flight — e.g. retried across a
                # device outage; the scheduler's commit for this mover
                # would double-count the single resident copy
                task.device.free_capacity(task.sim.io_bytes)
            else:
                self._add_residency(obj, task.device)

    # ------------------------------------- prefetch under producer pipelining
    def wants_deferred_stage(self, fut, target_tier: str) -> bool:
        """Should a consumer of the not-yet-finished producer behind ``fut``
        get a *conditional* staging chained onto the producer's completion?
        Only for pending I/O producers with a real output footprint that
        could ever fit the target tier — whether staging is actually useful
        is unknowable until the producer's output lands somewhere, which is
        exactly why the decision is deferred."""
        if target_tier not in self._rank:
            return False
        t = getattr(fut, "task", None)
        if t is None or t.state in (TaskState.DONE, TaskState.FAILED):
            return False  # resolved or doomed: nothing to defer
        if t.defn.task_type != TaskType.IO or t.sim.io_bytes <= 0:
            return False
        if t.defn.signature in ("tier_drain", "tier_prefetch"):
            return False  # movers move data; they are never staged
        return any(d.tier == target_tier and
                   (d.capacity_mb is None or t.sim.io_bytes <= d.capacity_mb)
                   for d in self.cluster.devices)

    def deferred_stage_future(self, fut, tier: str):
        """The already-minted conditional mover for ``fut``→``tier``, if
        any — every pipelined reader of the same pending output rides the
        same mover."""
        entry = self._deferred_stage.get(id(fut))
        return entry[1].get(tier) if entry is not None else None

    def begin_deferred_stage(self, fut, tier: str, mover_fut) -> None:
        entry = self._deferred_stage.get(id(fut))
        if entry is None:
            entry = self._deferred_stage[id(fut)] = (fut, {})
        entry[1][tier] = mover_fut
        self.n_deferred_stages += 1

    def _resolve_deferred(self, task: TaskInstance, obj: DataObject,
                          t: float) -> None:
        """The producer registered: decide each deferred staging now. A
        useful mover becomes a real staging (source tier known at last);
        a useless one — the output already landed on a tier at least as
        fast as the target — is neutralized into a zero-cost pass-through
        so its consumers release immediately."""
        for f in task.futures:
            entry = self._deferred_stage.pop(id(f), None)
            if entry is None:
                continue
            for tier, mover_fut in entry[1].items():
                mover = mover_fut.task
                self.map_future(mover_fut, obj)
                # consumers were submitted before the object existed: they
                # depend on the mover — pick them up as readers so eviction
                # can never select the object out from under them
                if self.graph is not None:
                    for ctid in mover.children:
                        child = self.graph.tasks.get(ctid)
                        if child is not None and child.state not in (
                                TaskState.DONE, TaskState.FAILED):
                            obj.begin_read(ctid, t)
                if self.wants_stage(obj, tier):
                    src = obj.fastest_tier(self.tier_rank)
                    src_dev = self.cluster.tier_spec(src) if src else None
                    mover.sim.io_bytes = obj.size_mb
                    mover.sim.duration = read_floor_time(
                        src_dev, obj.size_mb) if src_dev is not None else 0.0
                    self.begin_stage(obj, tier, mover_fut)
                else:
                    mover.sim.io_bytes = 0.0
                    mover.sim.duration = 0.0

    def wants_stage(self, obj: DataObject, target_tier: str) -> bool:
        """Is a prefetch of ``obj`` up to ``target_tier`` useful? Only when
        the object is resident somewhere, every copy is on a strictly slower
        tier, the target exists in the cluster, and at least one of the
        target's devices could ever hold it (an object bigger than the fast
        tier's total capacity must keep being read from where it lives —
        staging it would be rejected at submission)."""
        if target_tier not in self._rank:
            return False
        best = obj.fastest_tier(self.tier_rank)
        if best is None:
            return False
        if self.tier_rank(best) <= self.tier_rank(target_tier):
            return False
        return any(d.tier == target_tier and
                   (d.capacity_mb is None or obj.size_mb <= d.capacity_mb)
                   for d in self.cluster.devices)

    # ------------------------------------------------------------ eviction
    def _evictable(self, dev: StorageDevice) -> list[DataObject]:
        return [o for o in self._resident.get(id(dev), ())
                if not o.pinned and not o.readers and not o.evicting
                and not o.staging and not o.recovering]

    def plan_evictions(self, demand_mb: Optional[dict] = None
                       ) -> list[EvictionAction]:
        """Eviction planning pass over every finite device.

        Two triggers: occupancy above the tier's high watermark (drain back
        down to the low watermark), and *demand* — the scheduler reports a
        capacity-blocked grant (``{id(device): mb}``) and eviction frees at
        least that much even below the watermark. In-flight eviction volume
        is subtracted so ticks don't over-evict.
        """
        if not self.enabled or not self.config.auto_evict \
                or not self._finite_devs:
            return []
        demand_mb = demand_mb or {}
        actions: list[EvictionAction] = []
        for dev in self._finite_devs:
            cap = dev.capacity_mb
            if dev.tier == self.durable_tier:
                continue  # the backing store is never evicted
            hi, lo = self._watermarks(dev)
            in_flight = self._evicting_mb.get(id(dev), 0.0)
            occ = dev.occupancy_mb - in_flight
            need = 0.0
            if occ > hi * cap:
                need = occ - lo * cap
            want = demand_mb.get(id(dev), 0.0)
            if want > 0:
                free_after = cap - occ
                if free_after < want:
                    need = max(need, want - free_after)
            if need <= 0:
                continue
            chosen = self.config.policy.select(self._evictable(dev), need)
            t_sel = self.now()
            for obj in chosen:
                obj.evicting = True
                obj._selected_at = t_sel  # audited: no reader was scheduled
                self._evicting_mb[id(dev)] = \
                    self._evicting_mb.get(id(dev), 0.0) + obj.size_mb
                durable = self.durable_tier in obj.residency
                # ephemeral objects (rt.discard) skip the durable drain:
                # nobody will ever read them, so deletion is free — no FS
                # bandwidth spent writing back data on its way out
                actions.append(EvictionAction(
                    obj=obj, device=dev,
                    drain_to=None if durable or obj.ephemeral
                    else self.durable_tier))
        return actions

    def drop_now(self, obj: DataObject, dev: StorageDevice) -> None:
        """Immediate delete of a copy that has a durable sibling — or of an
        ephemeral object (rt.discard), which needs none."""
        assert obj.ephemeral or self.durable_tier in obj.residency, obj
        if obj.ephemeral:
            self.n_discards += 1
        self._record_eviction(
            obj, dev, mode="discard" if obj.ephemeral else "drop")
        dev.free_capacity(obj.size_mb)
        self._drop_residency(obj, dev)
        self._evicting_mb[id(dev)] = max(
            0.0, self._evicting_mb.get(id(dev), 0.0) - obj.size_mb)
        obj.evicting = False

    def _finish_evict(self, task: TaskInstance, obj: DataObject,
                      dev: StorageDevice, failed: bool) -> None:
        """Drain-then-delete completion: the durable copy landed (or the
        drain failed, in which case the fast copy survives untouched)."""
        self._evicting_mb[id(dev)] = max(
            0.0, self._evicting_mb.get(id(dev), 0.0) - obj.size_mb)
        obj.evicting = False
        if failed:
            return
        if task.device is not None:
            self._add_residency(obj, task.device)
        self._record_eviction(obj, dev, mode="drain")
        if obj.residency.get(dev.tier) is dev:
            # the copy can already be gone: the device went offline mid-
            # drain and on_device_offline dropped it (freeing the capacity)
            dev.free_capacity(obj.size_mb)
            self._drop_residency(obj, dev)

    def _finish_recovery(self, task: TaskInstance, obj: DataObject,
                         failed: bool) -> None:
        """Emergency re-drain / lineage re-run completion: the restored
        copy becomes residency of the *original* object (no new object is
        minted) and the object leaves its recovering state. A failed
        attempt (retries exhausted) leaves whatever copies survive."""
        obj.recovering = False
        if failed or task.device is None:
            return
        if obj.residency.get(task.device.tier) is not task.device:
            self._add_residency(obj, task.device)
        else:
            # an in-flight stage/mover beat the recovery to this device:
            # one resident copy, so one committed footprint
            task.device.free_capacity(task.sim.io_bytes)
        for f in task.futures:
            self.map_future(f, obj)

    # ------------------------------------------------------ failure domains
    def on_device_offline(self, dev: StorageDevice
                          ) -> tuple[list[DataObject], list[DataObject]]:
        """A device died (failures.py): every copy it held is gone. Drop
        the residencies — freeing the modelled occupancy so a recovered
        device starts empty — and classify the damage:

        * **orphans**: objects whose ONLY copy lived on ``dev``; they need
          a lineage re-run (``IORuntime._recover_object``);
        * **at_risk**: objects that keep a surviving copy on another tier
          but lost their durable-tier copy; they need an emergency
          re-drain (``IORuntime._issue_redrain``).

        Returns ``(orphans, at_risk)``, each in object-creation order.
        """
        if not self.enabled:
            return [], []
        orphans: list[DataObject] = []
        at_risk: list[DataObject] = []
        for obj in sorted(self._resident.get(id(dev), set()),
                          key=lambda o: o.oid):
            dev.free_capacity(obj.size_mb)
            self._drop_residency(obj, dev)
            self.events.append({
                "time": self.now(), "oid": obj.oid, "name": obj.name,
                "size_mb": obj.size_mb, "tier": dev.tier,
                "device": dev.name, "mode": "lost",
                "readers": len(obj.readers),
                "durable": self.durable_tier in obj.residency,
                "pinned": obj.pinned, "ephemeral": obj.ephemeral,
            })
            if self.recorder is not None:
                self.recorder.on_evict(self.now(), obj, dev, "lost")
            if not obj.residency:
                orphans.append(obj)
            elif dev.tier == self.durable_tier and not obj.ephemeral:
                at_risk.append(obj)
        return orphans, at_risk

    def _record_eviction(self, obj: DataObject, dev: StorageDevice,
                         mode: str) -> None:
        self.n_evictions += 1
        self.bytes_evicted_mb += obj.size_mb
        self.events.append({
            "time": self.now(), "oid": obj.oid, "name": obj.name,
            "size_mb": obj.size_mb, "tier": dev.tier, "device": dev.name,
            "mode": mode, "readers": len(obj.readers),
            "selected_at": getattr(obj, "_selected_at", self.now()),
            "durable": self.durable_tier in obj.residency,
            "pinned": obj.pinned,
            "ephemeral": obj.ephemeral,
        })
        if self.recorder is not None:
            self.recorder.on_evict(self.now(), obj, dev, mode)

    # ------------------------------------------------------------- summary
    def summary(self) -> dict:
        return {
            "enabled": self.enabled,
            "n_objects": len(self.objects),
            "n_prefetches": self.n_prefetches,
            "n_deferred_stages": self.n_deferred_stages,
            "n_evictions": self.n_evictions,
            "n_discards": self.n_discards,
            "n_lost_objects": len(self.lost_objects),
            "bytes_prefetched_mb": self.bytes_prefetched_mb,
            "bytes_evicted_mb": self.bytes_evicted_mb,
            "occupancy": {
                d.name: {
                    "tier": d.tier,
                    "capacity_mb": d.capacity_mb,
                    "used_mb": d.used_mb,
                    "reserved_mb": d.reserved_mb,
                    "peak_occupancy_mb": d.peak_occupancy_mb,
                }
                for d in self.cluster.devices if d.capacity_mb is not None
            },
        }
