"""The I/O-aware scheduler (paper §4.2).

Compute tasks are placed by computing-unit availability (the compute
execution platform). I/O tasks are placed by *I/O executor* availability and
*storage-bandwidth* budget (the I/O execution platform) — their computing
requirement is zero, so they overlap with compute tasks (paper §4.2.1).

Auto-constrained tasks are routed through a per-signature :class:`AutoTuner`.
While a tuner is learning, its tasks run only on a dedicated
*active-learning node* and no other I/O tasks are co-scheduled there
(paper §4.2.3B). Once learning finishes the node is released and the
objective function picks the constraint, re-evaluated on every arrival.

Tier-aware placement (multi-tier storage hierarchy): every worker carries an
ordered list of storage tiers (resources.py). An I/O task with no tier hint
is placed on the *fastest tier with budget*: the scheduler tries tier 0 on
every candidate worker, then tier 1, and so on down the hierarchy, so a
saturated node-local SSD spills to the burst buffer and then to the shared
FS instead of queueing. A tier hint (``@constraint(tier=...)`` or per-call
``storage_tier=``) pins the task to that tier's devices. Auto-constrained
tasks get one :class:`AutoTuner` per (signature, tier) — the optimal
constraint is a property of the device the tasks actually write to — keyed
``sig`` for the default tier and ``"sig@tier"`` for hinted ones.

Hot-path design (100k-task workloads): ready tasks are kept in per
*placement-class* FIFO deques — one class per (compute-units), (static-bw,
tier) or (auto signature, tier) — because two ready tasks of the same class
have identical placement requirements: if the head of a class cannot be
placed, no other member can either, so a pass attempts at most one task per
class instead of rescanning the whole ready list. A heap over class heads
keeps the global attempt order identical to the seed's submission-order
scan, and a dirty flag skips passes entirely unless a resource was freed, a
tuner epoch advanced, or a new task became ready. Unsatisfiable static
constraints (a storageBW no device can ever grant, or a tier hint naming a
tier no worker has) are rejected once per placement class at submission
time instead of being rescanned on every failed placement attempt.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Callable, Iterable, Optional

from .autotune import AutoTuner, DriftConfig
from .constraints import AutoSpec, StaticSpec, is_auto
from .resources import Cluster, StorageDevice, WorkerNode
from .storage_model import cross_tier_time
from .task import Future, TaskInstance, TaskState, TaskType


class SchedulerError(RuntimeError):
    pass


def eligible_devices(cluster: Cluster, tier: Optional[str],
                     healthy_only: bool = True) -> list[StorageDevice]:
    """Distinct devices a task with tier hint ``tier`` may ever be granted
    on (every tier of every worker when unhinted; shared devices appear
    once). Shared between submission-time class validation below and the
    static plan analyzer (repro.analysis.lint), so a lint diagnostic and a
    runtime ``SchedulerError`` can never disagree about placeability.

    Health-aware (failures.py): offline devices are not eligible — the
    scheduler never grants to them, and lint agrees. Degraded devices stay
    eligible (degradation is transient; nameplate bandwidth still bounds
    feasibility). ``healthy_only=False`` restores the raw topology view."""
    seen: set[int] = set()
    out: list[StorageDevice] = []
    for w in cluster.workers:
        if tier is None:
            devs = w.tiers
        else:
            d = w.tier_device(tier)
            devs = [d] if d is not None else []
        for d in devs:
            if healthy_only and d.health == "offline":
                continue
            if id(d) not in seen:
                seen.add(id(d))
                out.append(d)
    return out


class Scheduler:
    def __init__(self, cluster: Cluster,
                 launch: Callable[[TaskInstance, WorkerNode], None]):
        self.cluster = cluster
        self._launch = launch
        # per placement-class FIFO deques of ready tasks (see module docstring)
        self._ready_q: dict[tuple, deque[TaskInstance]] = {}
        self._ready_count = 0
        self._sig_ready: dict[str, int] = {}   # signature -> #ready (O(1))
        self._ready_seq = itertools.count()    # global readiness order
        # refusal epoch: one tick per dirty wake-up (completion, retry,
        # readiness, health/burst pokes). Blocked-head diagnoses are
        # memoized per (class, head, epoch) so a traced run scans each
        # blocked class once per event, not once per round (the diagnosis
        # walks every worker; see _diagnose_block).
        self._refusal_epoch = 0
        self._diag_cache: dict[tuple, tuple] = {}
        self._dirty = True                     # wake-up flag: anything changed
        #                                        since the last zero-progress pass?
        self._validated: set[tuple] = set()    # class keys proven satisfiable
        self._tier_depth = max((len(w.tiers) for w in cluster.workers),
                               default=1)
        self._recompute_tier_caps()
        self.running: set[int] = set()
        # tuners/learning_nodes are keyed per (signature, tier): plain ``sig``
        # for the default tier (seed-compatible), ``"sig@tier"`` for hints
        self.tuners: dict[str, AutoTuner] = {}
        self.learning_nodes: dict[str, WorkerNode] = {}
        # the *device* a tuner calibrates must be quiet too: on shared tiers
        # (burst buffer / FS) node-level isolation alone would let other
        # workers' traffic pollute the epoch measurements (paper §4.2.3B)
        self.learning_devices: dict[str, object] = {}   # key -> StorageDevice
        self._learning_dev_ids: set[int] = set()
        self.completed: list[TaskInstance] = []
        self.launch_log: list[tuple[float, str, str]] = []  # (tid, sig, worker)
        # data lifecycle (datalife.py): None unless the runtime wires an
        # enabled catalog — the capacity-less hot path stays untouched
        self.catalog = None
        # observability (obs/): None unless the runtime wires a recorder —
        # a disabled run pays one is-not-None check per readiness/refusal
        self.recorder = None
        self.capacity_blocked: dict[int, float] = {}  # id(dev) -> wanted MB
        # sharded control plane (shardplane.py): this scheduler's identity
        # inside a ShardedScheduler, and the lease broker gating bandwidth
        # grants on shared devices. The unsharded defaults cost one is-None
        # check per I/O grant and nothing else.
        self.shard_id = 0
        self.shard_lease = None
        # tuning extensions (interference.py / autotune.DriftConfig): both
        # default off, leaving the paper's placement byte-identical
        self.drift_config: Optional[DriftConfig] = None
        self.tier_objective = False
        self._probe_counts: dict[str, int] = {}  # sig -> steady grants (the
        #                                          cross-tier probe clock)

    def set_tuning(self, drift: Optional[DriftConfig] = None,
                   tier_objective: bool = False) -> None:
        """Wire the interference-era tuning extensions (runtime calls this):
        ``drift`` makes every AutoTuner monitor observed-vs-predicted task
        times and re-enter calibration when the curve goes stale;
        ``tier_objective`` turns the fastest-with-budget walk for
        tier-agnostic auto tasks into a measured decision across the
        learned per-tier T(n, c) curves, priced with the eviction drain a
        nearly-full fast tier would force."""
        self.drift_config = drift
        self.tier_objective = bool(tier_objective)

    def set_recorder(self, recorder) -> None:
        """Wire the trace recorder (runtime calls this when tracing is on):
        readiness, grant refusals (diagnosed per placement class), and
        queue-depth samples flow into the event stream."""
        self.recorder = recorder

    def set_catalog(self, catalog) -> None:
        """Wire the data catalog (runtime calls this when the lifecycle
        subsystem is enabled): grants then check + reserve tier capacity,
        completions commit it, and capacity-blocked demand is reported for
        demand-driven eviction."""
        self.catalog = catalog
        # the catalog may have applied TierCapacity budgets to devices
        self._recompute_tier_caps()

    def _recompute_tier_caps(self) -> None:
        """Per-tier (and any-tier, key None) LARGEST device capacity, with
        None meaning "some device is unlimited" — precomputed so the
        per-submission feasibility check stays O(1) on the 100k-task hot
        path (capacities are fixed once the runtime is constructed)."""
        self._tier_max_cap: dict = {}
        for d in self.cluster.devices:
            for key in (d.tier, None):
                if key in self._tier_max_cap \
                        and self._tier_max_cap[key] is None:
                    continue
                if d.capacity_mb is None:
                    self._tier_max_cap[key] = None
                else:
                    self._tier_max_cap[key] = max(
                        self._tier_max_cap.get(key, 0.0), d.capacity_mb)

    # ------------------------------------------------------------------ utils
    @property
    def _dirty(self) -> bool:
        return self._dirty_flag

    @_dirty.setter
    def _dirty(self, value: bool) -> None:
        """Every wake-up (True write) advances the refusal epoch — the
        cache key for memoized blocked-head diagnoses. Writes come from
        this class and from the runtime/backends (``scheduler._dirty =
        True`` on health transitions and burst boundaries), so the setter
        is the one chokepoint that sees them all."""
        if value:
            self._refusal_epoch += 1
        self._dirty_flag = value

    @staticmethod
    def _tuner_key(sig: str, tier: Optional[str]) -> str:
        return sig if tier is None else f"{sig}@{tier}"

    @staticmethod
    def _tier_on(w: WorkerNode, tier: Optional[str]):
        """The device ``tier`` resolves to on worker ``w``: the fastest
        (primary) device when no hint is given, else the named tier or None
        when the worker doesn't reach it."""
        return w.storage if tier is None else w.tier_device(tier)

    def tuner_for(self, task: TaskInstance,
                  node: Optional[WorkerNode] = None) -> AutoTuner:
        return self._make_tuner(
            self._tuner_key(task.defn.signature, task.tier),
            task.storage_bw, node, task.tier)

    def _make_tuner(self, key: str, spec, node: Optional[WorkerNode],
                    tier: Optional[str]) -> AutoTuner:
        if key not in self.tuners:
            assert isinstance(spec, AutoSpec)
            # the device model the tuner reasons about: the tier device of
            # the active-learning node its epochs actually run on (falls back
            # to the first worker when called before a node is acquired).
            w = node if node is not None else self.cluster.workers[0]
            dev = self._tier_on(w, tier) or w.storage
            self.tuners[key] = AutoTuner(
                key, spec, device_bw=dev.bandwidth,
                io_executors=w.io_executors, drift=self.drift_config)
        return self.tuners[key]

    def _acquire_learning_node(self, key: str,
                               tier: Optional[str] = None
                               ) -> Optional[WorkerNode]:
        node = self.learning_nodes.get(key)
        if node is not None:
            return node
        for w in self.cluster.workers:
            if w.learning_owner is not None:
                continue
            dev = self._tier_on(w, tier)
            if dev is None or id(dev) in self._learning_dev_ids \
                    or dev.health == "offline":
                continue  # tier absent, under calibration, or failed
            w.learning_owner = key
            self.learning_nodes[key] = w
            self.learning_devices[key] = dev
            self._learning_dev_ids.add(id(dev))
            return w
        return None  # all nodes busy learning other signatures: wait

    def _release_learning_node(self, key: str) -> None:
        node = self.learning_nodes.pop(key, None)
        if node is not None:
            node.learning_owner = None
            dev = self.learning_devices.pop(key, None)
            if dev is not None:
                self._learning_dev_ids.discard(id(dev))
            self._dirty = True

    def n_ready_of(self, sig: str) -> int:
        return self._sig_ready.get(sig, 0)

    @property
    def n_ready(self) -> int:
        return self._ready_count

    @property
    def ready(self) -> list[TaskInstance]:
        """Materialised ready list in readiness order (debug/reporting only —
        the hot path never builds this)."""
        tasks = [t for q in self._ready_q.values() for t in q]
        tasks.sort(key=lambda t: t._ready_seq)
        return tasks

    @staticmethod
    def _class_key(task: TaskInstance) -> tuple:
        """Placement class: tasks with the same key have identical placement
        requirements at any scheduler state."""
        d = task.defn
        if d.task_type == TaskType.COMPUTE:
            return ("C", d.computing_units)
        spec = task.storage_bw
        if is_auto(spec):
            return ("A", d.signature, task.tier)
        bw = spec.value if isinstance(spec, StaticSpec) else 0.0
        return ("S", bw, task.tier)

    def validate_submit(self, task: TaskInstance) -> None:
        """Called by the runtime *before* the task enters the graph, so an
        unsatisfiable class raises at the submission call site with no
        half-registered state left behind (and never from a completion
        fan-out on a backend worker thread)."""
        self._validate_class(self._class_key(task))
        # per-task (not per-class) feasibility: an output footprint larger
        # than every eligible device's TOTAL capacity can never be granted,
        # not even after evicting everything — without this check the task
        # would block its placement class forever and the run would die with
        # a generic "scheduler stuck" at the barrier. Only meaningful while
        # capacity is enforced (catalog wired; see _capacity_ok).
        mb = task.sim.io_bytes
        if self.catalog is None or task.defn.task_type == TaskType.COMPUTE \
                or mb <= 0:
            return
        tier = task.tier
        # (an unknown tier already raised in _validate_class above)
        cap = self._tier_max_cap.get(tier if tier is not None else None)
        if cap is not None and mb > cap:
            raise SchedulerError(
                f"io_mb={mb} exceeds every eligible device's total "
                f"capacity"
                + (f" on tier {tier!r}" if tier is not None else "")
                + f" (max {cap:.0f} MB)")

    def _validate_class(self, key: tuple) -> None:
        """Once-per-class satisfiability check (at submission time): a static
        storageBW no eligible device can ever grant, or a tier hint naming a
        tier no worker reaches, would otherwise fail every placement attempt
        forever — the seed rescanned all workers on *each* attempt instead.
        Only satisfiable keys are cached: a rejected class is re-diagnosed
        (same precise error) if the caller retries it."""
        if key in self._validated:
            return
        if key[0] == "C":
            self._validated.add(key)
            return
        tier = key[2]
        if tier is not None and not any(
                w.tier_device(tier) is not None for w in self.cluster.workers):
            raise SchedulerError(
                f"storage tier {tier!r} is not present on any worker "
                f"(available: {self.cluster.tier_names()})")
        if key[0] == "S" and key[1] > 0:
            bw = key[1]
            devs = eligible_devices(self.cluster, tier)
            # an all-offline tier leaves devs empty: the class queues until
            # the tier recovers instead of being rejected as unsatisfiable
            if devs and all(d.bandwidth < bw for d in devs):
                raise SchedulerError(
                    f"storageBW={bw} exceeds every device's bandwidth"
                    + (f" on tier {tier!r}" if tier is not None else ""))
        self._validated.add(key)

    def _sig_key(self, task: TaskInstance) -> str:
        """Backlog-count key: auto I/O tasks count per (signature, tier) —
        the backlog feeds that tier's tuner objective — others per
        signature."""
        if task.defn.task_type != TaskType.COMPUTE and \
                is_auto(task.storage_bw):
            return self._tuner_key(task.defn.signature, task.tier)
        return task.defn.signature

    # -------------------------------------------------------------- submission
    def make_ready(self, task: TaskInstance) -> None:
        task._ready_seq = next(self._ready_seq)
        key = self._class_key(task)
        q = self._ready_q.get(key)
        if q is None:
            q = self._ready_q[key] = deque()
        q.append(task)
        self._ready_count += 1
        sig = self._sig_key(task)
        self._sig_ready[sig] = self._sig_ready.get(sig, 0) + 1
        self._dirty = True
        if self.recorder is not None:
            self.recorder.on_ready(task, key)

    def make_ready_many(self, tasks: Iterable[TaskInstance]) -> None:
        """Batched completion fan-out: newly-ready children arrive together
        (in submission order) so the pass that follows sees them all."""
        for t in tasks:
            self.make_ready(t)

    # -------------------------------------------------------------- scheduling
    def schedule_pass(self) -> int:
        """Try to place every ready task; returns number launched.

        Event-driven: returns immediately unless something changed since the
        last zero-progress pass (resource freed, tuner epoch advanced, new
        ready task). Within a pass, class heads are attempted in global
        readiness order; a failed head blocks its whole class for the rest of
        the round (identical requirements => identical outcome), and rounds
        repeat until one launches nothing — matching the seed's
        ``while progress`` full-rescan semantics at O(log n) per attempt.
        """
        if not self._dirty or self._ready_count == 0:
            return 0
        launched = 0
        while True:
            n = self._round()
            launched += n
            if n == 0:
                break
        self._dirty = False
        return launched

    def _round(self) -> int:
        heads = [(q[0]._ready_seq, key)
                 for key, q in self._ready_q.items() if q]
        heapq.heapify(heads)
        launched = 0
        while heads:
            _, key = heapq.heappop(heads)
            if self._attempt_head(key):
                launched += 1
                q = self._ready_q.get(key)
                if q:
                    heapq.heappush(heads, (q[0]._ready_seq, key))
        return launched

    def _attempt_head(self, key: tuple) -> bool:
        """One placement attempt on the head of class ``key`` (no re-queue):
        True launched and dequeued it; False leaves the class blocked for
        the rest of the round. The sharded control plane
        (shardplane.ShardedScheduler) calls this directly so its global
        round can interleave class heads across shards in readiness order."""
        q = self._ready_q[key]
        task = q[0]
        if self._try_place(task):
            q.popleft()
            self._ready_count -= 1
            sig = self._sig_key(task)
            self._sig_ready[sig] -= 1
            if not self._sig_ready[sig]:
                del self._sig_ready[sig]
            if not q:
                # drop drained classes so rounds stay O(live classes)
                # (per-call storage_bw overrides can mint many keys)
                del self._ready_q[key]
            return True
        if self.recorder is not None:
            # class blocked until the next round — diagnose why (pure
            # reads) so ready->launch time is attributable per class.
            # Memoized per (class, head, refusal epoch): re-diagnosing
            # the same head within one dirty wake-up would re-walk every
            # worker per round for an answer that only event-level state
            # changes can alter (within a pass resources only shrink).
            cached = self._diag_cache.get(key)
            if cached is not None and cached[0] == self._refusal_epoch \
                    and cached[1] == task.tid:
                reason, dev_name, wanted = cached[2]
            else:
                result = self._diagnose_block(task)
                self._diag_cache[key] = (
                    self._refusal_epoch, task.tid, result)
                reason, dev_name, wanted = result
            self.recorder.note_block(key, reason, dev_name, wanted)
        # else: class blocked until the next round — nothing that happens
        # later in this round can make it placeable (resources only shrink)
        return False

    def _diagnose_block(self, task: TaskInstance) -> tuple:
        """Classify why ``task`` (a blocked class head) could not be placed
        just now: re-walk the candidates the attempt tried with pure reads
        (never mutates scheduler, tuner, or device state — recording must
        leave placement byte-identical) and report the dominant refusal,
        ``(reason, device_name, wanted_mb)``. Precedence mirrors severity:
        capacity > bandwidth > executor > learning > offline."""
        d = task.defn
        if d.task_type == TaskType.COMPUTE:
            return "cpu", None, 0.0
        tier = task.tier
        spec = task.storage_bw
        bw = 0.0
        if is_auto(spec):
            if self.tier_objective and tier is None and self._tier_depth > 1:
                # cross-tier objective: learning while any tier's curve is
                # unlearned; afterwards diagnose with the first tier's choice
                tuner = None
                for tname in self.cluster.tier_names():
                    t = self.tuners.get(self._tuner_key(d.signature, tname))
                    if t is None or t.learning():
                        return "learning", None, 0.0
                    if tuner is None:
                        tuner = t
            else:
                key = self._tuner_key(d.signature, tier)
                tuner = self.tuners.get(key)
                if tuner is None or tuner.learning():
                    return "learning", None, 0.0
            bw = tuner.peek_choice(max(1, self.n_ready_of(
                self._sig_key(task))))
        elif isinstance(spec, StaticSpec):
            bw = spec.value
        wanted = task.sim.io_bytes
        seen: dict[str, Optional[str]] = {}
        for w in self.cluster.workers:
            devs = [w.tier_device(tier)] if tier is not None else w.tiers
            for dev in devs:
                if dev is None:
                    continue
                if dev.health == "offline":
                    seen.setdefault("offline", dev.name)
                elif w.learning_owner is not None \
                        or id(dev) in self._learning_dev_ids:
                    seen.setdefault("learning", dev.name)
                elif w.free_io_executors <= 0:
                    seen.setdefault("executor", dev.name)
                elif bw > 0 and not dev.can_allocate(bw):
                    seen.setdefault("bandwidth", dev.name)
                elif self.catalog is not None \
                        and dev.capacity_gb is not None and wanted > 0 \
                        and not dev.can_reserve_capacity(wanted):
                    seen.setdefault("capacity", dev.name)
        for reason in ("capacity", "bandwidth", "executor", "learning",
                       "offline"):
            name = seen.get(reason)
            if name is not None:
                return reason, name, wanted if reason == "capacity" else 0.0
        return "unattributed", None, 0.0

    def _try_place(self, task: TaskInstance) -> bool:
        if task.defn.task_type == TaskType.COMPUTE:
            return self._place_compute(task)
        return self._place_io(task)

    def _place_compute(self, task: TaskInstance) -> bool:
        cu = task.defn.computing_units
        for w in self.cluster.workers:
            if w.free_cpus >= cu:
                w.free_cpus -= cu
                self._start(task, w, bw=0.0)
                return True
        return False

    def _place_io(self, task: TaskInstance) -> bool:
        spec = task.storage_bw
        if is_auto(spec):
            return self._place_auto_io(task)
        bw = spec.value if isinstance(spec, StaticSpec) else 0.0
        # (unsatisfiable constraints were rejected per-class at submission)
        tier = task.tier
        candidates = self._io_candidates(task)
        if tier is not None:
            # pinned: only devices backing the named tier qualify
            for w in candidates:
                dev = w.tier_device(tier)
                if dev is not None and self._grant_io(task, w, dev, bw):
                    return True
            return False
        # tier-agnostic: fastest tier with budget wins — try every worker's
        # tier 0, then every worker's tier 1, ... (fall down the hierarchy)
        for ti in range(self._tier_depth):
            for w in candidates:
                if ti >= len(w.tiers):
                    continue
                if self._grant_io(task, w, w.tiers[ti], bw):
                    return True
        return False

    def _capacity_ok(self, task: TaskInstance, dev) -> bool:
        """Capacity side of a grant: the task's output footprint must fit on
        the device (unlimited tiers always fit). A refusal is recorded as
        *demand* so the runtime's lifecycle tick can evict to make room —
        the tier-agnostic walk meanwhile spills the task down the
        hierarchy. Gated on the catalog: with the lifecycle subsystem
        explicitly disabled nothing would ever free occupancy, so enforcing
        the budget would wedge pinned workloads — capacity_gb is then
        documentation, not a constraint."""
        if self.catalog is None or dev.capacity_gb is None \
                or task.sim.io_bytes <= 0:
            return True
        if dev.can_reserve_capacity(task.sim.io_bytes):
            return True
        did = id(dev)
        self.capacity_blocked[did] = max(
            self.capacity_blocked.get(did, 0.0), task.sim.io_bytes)
        return False

    def _reserve_capacity(self, task: TaskInstance, dev) -> None:
        """Reserve-at-grant (commit happens in on_complete)."""
        if self.catalog is None or dev.capacity_gb is None \
                or task.sim.io_bytes <= 0:
            return
        dev.reserve_capacity(task.sim.io_bytes)
        task.reserved_mb = task.sim.io_bytes

    def _grant_io(self, task: TaskInstance, w: WorkerNode, dev,
                  bw: float) -> bool:
        if w.learning_owner is not None:
            return False  # active-learning node: keep it isolated
        if id(dev) in self._learning_dev_ids:
            return False  # device under calibration (shared-tier isolation)
        if dev.health == "offline":
            return False  # failed device: bw=0 grants bypass can_allocate,
            #               so the health gate must be explicit
        if w.free_io_executors <= 0:
            return False
        if bw > 0 and not dev.can_allocate(bw):
            return False
        if not self._capacity_ok(task, dev):
            return False
        if bw > 0 and self.shard_lease is not None \
                and not self.shard_lease.acquire(self.shard_id, dev, bw):
            return False
        w.free_io_executors -= 1
        if bw >= 0:
            dev.allocate(bw)
        self._reserve_capacity(task, dev)
        self._start(task, w, bw=bw, device=dev)
        return True

    def _learning_grant(self, task: TaskInstance, key: str,
                        tier: Optional[str]) -> bool:
        """Admit the task into ``key``'s current learning epoch on that
        tuner's dedicated active-learning node (paper §4.2.3B)."""
        node = self._acquire_learning_node(key, tier)
        if node is None:
            return False
        dev = self._tier_on(node, tier)
        if dev.health == "offline":
            return False
        # the tuner models the device it actually learns on
        tuner = self._make_tuner(key, task.storage_bw, node, tier)
        c = tuner.current_constraint()
        if node.free_io_executors <= 0 or not dev.can_allocate(c):
            return False
        if not self._capacity_ok(task, dev):
            return False
        # lease before admit: un-admitting is observable tuner state, so the
        # lease (pure accounting, and always grantable after can_allocate —
        # see shardplane.LeaseBroker) is the one taken tentatively
        if c > 0 and self.shard_lease is not None \
                and not self.shard_lease.acquire(self.shard_id, dev, c):
            return False
        if not tuner.admit():
            if c > 0 and self.shard_lease is not None:
                self.shard_lease.release(self.shard_id, dev, c)
            return False  # current epoch full; wait for the next one
        node.free_io_executors -= 1
        dev.allocate(c)
        self._reserve_capacity(task, dev)
        task.epoch = tuner.epoch
        task.tuner_key = key
        self._start(task, node, bw=c, device=dev)
        return True

    def _steady_grant(self, task: TaskInstance, key: str,
                      tier: Optional[str], tuner: AutoTuner,
                      c: float) -> bool:
        """Place a steady-phase auto task under constraint ``c`` on the
        first candidate worker with budget on ``tier``."""
        for w in self._io_candidates(task):
            if w.learning_owner is not None:
                continue
            dev = self._tier_on(w, tier)
            if dev is None or id(dev) in self._learning_dev_ids \
                    or dev.health == "offline":
                continue
            if w.free_io_executors <= 0 or not dev.can_allocate(c):
                continue
            if not self._capacity_ok(task, dev):
                continue
            if c > 0 and self.shard_lease is not None \
                    and not self.shard_lease.acquire(self.shard_id, dev, c):
                continue
            w.free_io_executors -= 1
            dev.allocate(c)
            self._reserve_capacity(task, dev)
            tuner.record_choice(c)
            task.tuner_key = key
            self._start(task, w, bw=c, device=dev)
            return True
        return False

    def _place_auto_io(self, task: TaskInstance) -> bool:
        sig = task.defn.signature
        tier = task.tier
        if self.tier_objective and tier is None and self._tier_depth > 1:
            return self._place_auto_io_cross_tier(task)
        key = self._tuner_key(sig, tier)
        tuner = self.tuners.get(key)
        if tuner is None or tuner.learning():
            return self._learning_grant(task, key, tier)
        # learning done: objective fn, re-evaluated for the current backlog
        # of THIS (signature, tier) — not siblings targeting other tiers
        n = self.n_ready_of(key)
        c = tuner.peek_choice(max(1, n))
        return self._steady_grant(task, key, tier, tuner, c)

    def _place_auto_io_cross_tier(self, task: TaskInstance) -> bool:
        """Measured tier choice for tier-agnostic auto tasks: calibrate a
        tuner per tier (hierarchy order, one at a time), then compare the
        learned T(n, c) curves across tiers — plus the eviction-drain price
        of writing to a nearly-full tier — and place on the argmin. Under
        interference each tier's *effective* curve differs from its
        nameplate ordering, so the walk is a measurement, not a heuristic;
        drifted tuners re-enter calibration and the ranking follows."""
        sig = task.defn.signature
        tiers = self.cluster.tier_names()
        # phase 1: the first tier whose curve is unlearned (or stale —
        # drift re-entered calibration) learns next; one tier at a time so
        # learning-node isolation is per-device, not cluster-wide
        for tier in tiers:
            key = self._tuner_key(sig, tier)
            tuner = self.tuners.get(key)
            if tuner is None or tuner.learning():
                return self._learning_grant(task, key, tier)
        # phase 2: every tier measured — argmin of backlog completion time
        n = max(1, self.n_ready_of(self._sig_key(task)))
        ranked = []
        for ti, tier in enumerate(tiers):
            key = self._tuner_key(sig, tier)
            tuner = self.tuners[key]
            c = tuner.peek_choice(n)
            t_est = tuner.objective_time(n, c) \
                + self._eviction_price(tier, task.sim.io_bytes)
            ranked.append((t_est, ti, c, tier, key, tuner))
        ranked.sort(key=lambda r: (r[0], r[1]))  # ties: faster tier wins
        # re-probe: a tier the argmin abandons stops producing observations,
        # so a stale-pessimistic curve could lock it out even after its
        # co-tenant leaves. With drift monitoring on, every Nth steady grant
        # goes to the runner-up instead — a deterministic exploration beat
        # that keeps every arm's curve fresh enough to drift back. The beat
        # counts *grants*, not attempts: a blocked class head is retried on
        # every round, and burning beats on failures would starve the probe
        # exactly when congestion makes it matter.
        if self.drift_config is not None and len(ranked) > 1 and \
                (self._probe_counts.get(sig, 0) + 1) \
                % self.drift_config.probe_every == 0:
            ranked[0], ranked[1] = ranked[1], ranked[0]
        for _, _, c, tier, key, tuner in ranked:
            if self._steady_grant(task, key, tier, tuner, c):
                if self.drift_config is not None:
                    self._probe_counts[sig] = \
                        self._probe_counts.get(sig, 0) + 1
                return True
        return False

    def _eviction_price(self, tier: str, io_mb: float) -> float:
        """The drain cost a write of ``io_mb`` to ``tier`` would force: if
        the projected occupancy of the tier's representative device crosses
        its high watermark, the spill back down to the low watermark is a
        cross-tier move to the durable tier — time the objective must pay
        for choosing this tier. Zero without the lifecycle subsystem (no
        finite capacity means no eviction ever)."""
        if self.catalog is None or io_mb <= 0:
            return 0.0
        dev = self.cluster.tier_spec(tier)
        if dev is None or dev.capacity_mb is None:
            return 0.0
        durable = self.catalog.durable_tier
        if durable is None or durable == tier:
            return 0.0
        dst = self.cluster.tier_spec(durable)
        if dst is None:
            return 0.0
        hi, lo = self.catalog.watermarks(dev)
        cap = dev.capacity_mb
        projected = dev.occupancy_mb + io_mb
        if projected <= hi * cap:
            return 0.0
        spill = projected - lo * cap
        return cross_tier_time(dev, dst, spill)

    def _io_candidates(self, task: TaskInstance):
        # shared working directory -> first candidate node (paper §4.2.1);
        # otherwise honour data locality (inputs' producing workers first).
        if self.cluster.shared_workdir:
            return self.cluster.workers
        pref, pref_ids = [], set()
        for a in list(task.args) + list(task.kwargs.values()):
            if isinstance(a, Future) and a.task.worker is not None:
                w = a.task.worker
                if id(w) not in pref_ids:  # O(1) membership (seed: list `in`)
                    pref_ids.add(id(w))
                    pref.append(w)
        rest = [w for w in self.cluster.workers if id(w) not in pref_ids]
        return pref + rest

    def _start(self, task: TaskInstance, worker: WorkerNode, bw: float,
               device=None) -> None:
        task.worker = worker
        task.device = device
        task.granted_bw = bw
        task.state = TaskState.RUNNING
        if self.catalog is not None:
            # read penalty snapshot: inputs are charged from their fastest
            # resident tier as of this grant (must precede backend.launch,
            # which bakes the penalty into the task's finish estimate)
            self.catalog.on_grant(task)
        self.running.add(task.tid)
        self.launch_log.append((task.tid, task.defn.signature, worker.name))
        self._launch(task, worker)

    # -------------------------------------------------------------- completion
    def on_complete(self, task: TaskInstance) -> None:
        """Release resources + autotune bookkeeping. The backend/runtime is
        responsible for graph completion and follow-up scheduling."""
        self.running.discard(task.tid)
        w = task.worker
        if task.defn.task_type == TaskType.COMPUTE:
            w.free_cpus += task.defn.computing_units
        else:
            w.free_io_executors += 1
            dev = task.device or w.storage
            dev.release(task.granted_bw)
            if self.shard_lease is not None and task.granted_bw > 0:
                self.shard_lease.release(self.shard_id, dev, task.granted_bw)
            if task.reserved_mb:
                # commit-at-finish: the written bytes become resident data;
                # a failed writer's reservation is returned instead
                if task.state == TaskState.FAILED:
                    dev.cancel_reservation(task.reserved_mb)
                else:
                    dev.commit_capacity(task.reserved_mb)
        # the duration the tuner/drift feedback sees: the RealBackend
        # records the final successful attempt's wall time on the task
        # (measured_duration) — task.duration there also counts pool
        # queueing, argument resolution and failed attempts' backoff, which
        # would poison the learned T(n, c) curve. Sim tasks never set it,
        # so the modelled duration feeds through bit-identically.
        dur = task.measured_duration
        if dur is None:
            dur = task.duration
        if task.epoch is not None:
            # the grant recorded which (signature, tier) tuner admitted it —
            # under the cross-tier objective a tier-agnostic task may have
            # calibrated any tier's curve (fallback: recompute, for A/B
            # scheduler shims that predate tuner_key)
            key = task.tuner_key or self._tuner_key(
                task.defn.signature, task.tier)
            tuner = self.tuners[key]
            tuner.on_task_complete(dur)
            if not tuner.learning():
                self._release_learning_node(key)
        elif self.drift_config is not None and task.tuner_key is not None:
            # steady-phase drift feedback: compare the observed task time
            # against the learned curve; the tuner may re-enter calibration
            tuner = self.tuners.get(task.tuner_key)
            if tuner is not None:
                tuner.observe(task.granted_bw, dur)
        self.completed.append(task)
        self._dirty = True  # a resource was freed (and maybe an epoch advanced)

    def on_retry(self, task: TaskInstance) -> None:
        """Release a failed attempt's resources *without* the completion
        bookkeeping (no ``completed`` entry, no tuner feedback — the task
        is not done, it will be re-granted). Mirrors ``on_complete``'s
        resource side: executors, bandwidth, and the capacity reservation
        all return; a learning-epoch membership is un-admitted so the epoch
        can still conclude."""
        self.running.discard(task.tid)
        w = task.worker
        if task.defn.task_type == TaskType.COMPUTE:
            w.free_cpus += task.defn.computing_units
        else:
            w.free_io_executors += 1
            dev = task.device or w.storage
            dev.release(task.granted_bw)
            if self.shard_lease is not None and task.granted_bw > 0:
                self.shard_lease.release(self.shard_id, dev, task.granted_bw)
            if task.reserved_mb:
                dev.cancel_reservation(task.reserved_mb)
        if task.epoch is not None:
            # the attempt never completes, so its admission must not leave
            # the epoch waiting forever on completed >= admitted
            task.epoch.admitted -= 1
            key = task.tuner_key or self._tuner_key(
                task.defn.signature, task.tier)
            tuner = self.tuners.get(key)
            if tuner is not None and tuner.epoch is task.epoch \
                    and tuner.learning() and task.epoch.done():
                # the un-admit concluded the current epoch (its other
                # members all finished): advance as a completion would have
                tuner._advance()
                if not tuner.learning():
                    self._release_learning_node(key)
        self._dirty = True

    def end_of_stream(self) -> None:
        """Signal that no more tasks will be submitted (final barrier):
        lets partially-filled learning epochs conclude."""
        for key, tuner in self.tuners.items():
            if tuner.learning():
                tuner.end_of_stream()
                self._dirty = True
                if not tuner.learning():
                    self._release_learning_node(key)

    # ---------------------------------------------------------------- sanity
    def assert_not_stuck(self) -> None:
        if self._ready_count and not self.running:
            # one legitimate transient: an auto task waiting for a learning
            # node held by a tuner whose epoch is waiting for more arrivals.
            self.end_of_stream()
            self._dirty = True
            if self.schedule_pass() == 0 and self._ready_count \
                    and not self.running:
                names = [t.defn.name for t in self.ready[:5]]
                raise SchedulerError(
                    f"scheduler stuck: {self._ready_count} ready tasks "
                    f"(e.g. {names}) but nothing running/placeable")
