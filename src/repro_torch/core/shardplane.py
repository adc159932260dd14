"""Sharded scheduler control plane: scale-out beyond one scheduler state.

A single :class:`~repro.core.scheduler.Scheduler` owns one set of ready
deques, placement classes, tuners and (in the simulator) one event heap.
That design is simple and bit-reproducible, but every scheduling decision
walks data structures whose size grows with the whole cluster. This module
partitions the cluster's workers into **shards** — contiguous worker
blocks, each owned by an ordinary sub-``Scheduler`` over a sub-``Cluster``
view — and composes them behind :class:`ShardedScheduler`, a facade that
speaks the exact external scheduler interface the runtime drives.

Design contract (see docs/scale.md for the full write-up):

* **Placement confinement** — a task is owned by exactly one shard
  (``task.shard``) and only ever placed on that shard's workers. Routing
  happens once, at submission (:meth:`ShardedScheduler.route`): an explicit
  ``shard_key=`` call-time anchor wins, else the task inherits its first
  Future input's producer shard (data locality), else deterministic
  round-robin over *workers* (not shards, so the anchor a task gets does
  not depend on the shard count).
* **Global-order rounds** — one scheduling round pops class heads from a
  single heap over *all* shards' placement classes, ordered by the shared
  global readiness sequence. With one shard this is literally the plain
  scheduler's round; with N shards the merged launch log is deterministic
  and, for workloads whose placement is shard-symmetric, identical across
  shard counts.
* **Message-passing boundary** — cross-shard effects travel as ordered
  :class:`ShardBus` messages: dependency-completion readiness
  (``DEP_DONE``/``DEP_FAILED``), catalog residency updates
  (``RESIDENCY_ADD``/``RESIDENCY_DROP``) and lease movements
  (``LEASE_GRANT``/``LEASE_RELEASE``). The bus assigns each message a
  global sequence number and delivers in that order. Consistency contract:
  because shards share one address space, state mutations are applied
  synchronously (never partially) and the bus drain at every readiness
  batch and at ``schedule_pass`` entry guarantees any posted update is
  visible before the next scheduling decision of the same virtual instant.
* **Shared tiers are leased** — devices referenced by workers of two or
  more shards (the burst buffer and shared FS of ``Cluster.make_tiered``)
  are the only cross-shard resource. A :class:`LeaseBroker` splits each
  shared device's bandwidth budget evenly into per-shard lease accounts;
  a grant that exceeds the shard's lease pulls unused grant from the other
  shards in deterministic shard order (on-demand rebalancing). Because
  rebalancing can always gather the device's full free budget, the broker
  never refuses a grant the device itself could satisfy — leases change
  accounting and observability, not placement — and the over-commit
  invariant (``used <= granted`` per shard, ``sum(granted) == budget`` per
  device) is machine-checkable at any instant.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Callable, Optional

from .graph import iter_futures
from .resources import Cluster, StorageDevice
from .scheduler import Scheduler, SchedulerError
from .task import TaskInstance, TaskState

# ---------------------------------------------------------------------------
# Message kinds (stable API: docs/scale.md and the shard tests key on these)
# ---------------------------------------------------------------------------
MSG_DEP_DONE = "DEP_DONE"            # dependency satisfied -> task ready
MSG_DEP_FAILED = "DEP_FAILED"        # failure fan-out unblocked an anti-dep
MSG_RESIDENCY_ADD = "RESIDENCY_ADD"  # catalog: object copy appeared on a tier
MSG_RESIDENCY_DROP = "RESIDENCY_DROP"
MSG_LEASE_GRANT = "LEASE_GRANT"      # broker: bandwidth drawn from a lease
MSG_LEASE_RELEASE = "LEASE_RELEASE"  # broker: bandwidth returned / rebalanced

MESSAGE_KINDS = (MSG_DEP_DONE, MSG_DEP_FAILED, MSG_RESIDENCY_ADD,
                 MSG_RESIDENCY_DROP, MSG_LEASE_GRANT, MSG_LEASE_RELEASE)

#: readiness kinds — the only ones whose delivery calls into a sub-scheduler
_READY_KINDS = (MSG_DEP_DONE, MSG_DEP_FAILED)

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Routing (pure functions — shared with the static analyzer, repro.analysis)
# ---------------------------------------------------------------------------
def shard_of_worker(widx: int, n_workers: int, n_shards: int) -> int:
    """The shard owning worker index ``widx`` under a contiguous fair
    partition of ``n_workers`` workers into ``n_shards`` blocks."""
    return widx * n_shards // n_workers


def shard_workers(shard: int, n_workers: int, n_shards: int) -> range:
    """Worker indices owned by ``shard`` (exact inverse of
    :func:`shard_of_worker`): ``w`` is owned by ``s`` iff ``s <= w *
    n_shards / n_workers < s + 1``, i.e. ``w`` in ``[ceil(s * n_workers /
    n_shards), ceil((s + 1) * n_workers / n_shards))``."""
    return range(-(-shard * n_workers // n_shards),
                 -(-(shard + 1) * n_workers // n_shards))


def anchor_worker(shard_key: int, n_workers: int) -> int:
    """The worker index an explicit ``shard_key=`` anchors to. Independent
    of the shard count: the same key always lands on the same worker, and
    :func:`shard_of_worker` then maps that worker to its owner — so a key
    that co-locates two tasks at one shard count co-locates them at every
    shard count that keeps their anchor workers in one block."""
    return int(shard_key) % n_workers


def partition_cluster(cluster: Cluster, n_shards: int) -> list[Cluster]:
    """Contiguous sub-``Cluster`` views, one per shard. Worker and device
    objects are *shared* with the parent cluster (views, not copies):
    resource accounting stays global, which is what makes shared tiers a
    real cross-shard resource and shard-private tiers naturally confined."""
    n_workers = len(cluster.workers)
    if not 1 <= n_shards <= n_workers:
        raise ValueError(
            f"n_shards must be in [1, n_workers={n_workers}], "
            f"got {n_shards}")
    return [Cluster(workers=[cluster.workers[i]
                             for i in shard_workers(s, n_workers, n_shards)],
                    shared_workdir=cluster.shared_workdir)
            for s in range(n_shards)]


def shared_devices(cluster: Cluster, n_shards: int) -> list[StorageDevice]:
    """Devices referenced by workers of two or more shards — the lease
    broker's domain. On ``Cluster.make_tiered`` these are the burst buffer
    and the shared FS; per-worker SSDs never qualify."""
    n_workers = len(cluster.workers)
    owners: dict[int, set[int]] = {}
    order: list[StorageDevice] = []
    for widx, w in enumerate(cluster.workers):
        s = shard_of_worker(widx, n_workers, n_shards)
        for dev in w.tiers:
            if id(dev) not in owners:
                owners[id(dev)] = set()
                order.append(dev)
            owners[id(dev)].add(s)
    return [d for d in order if len(owners[id(d)]) > 1]


# ---------------------------------------------------------------------------
# Bus: the ordered cross-shard message boundary
# ---------------------------------------------------------------------------
class ShardBus:
    """Ordered message channel between shards.

    Every cross-shard-visible effect is posted as a message carrying a
    global sequence number; :meth:`drain` delivers pending messages in
    sequence order through the deliver callback (readiness kinds) and
    retains per-kind / cross-vs-local counters for all of them. ``dst`` is
    a shard index, or ``None`` for broadcast state (residency updates every
    shard may read).
    """

    def __init__(self, n_shards: int,
                 deliver: Optional[Callable] = None):
        self.n_shards = n_shards
        self._deliver = deliver
        self._seq = itertools.count()
        self._pending: deque = deque()
        self.counters: dict[str, int] = {k: 0 for k in MESSAGE_KINDS}
        self.cross = 0       # src != dst (or broadcast): crossed the boundary
        self.local = 0       # src == dst: same-shard delivery
        self.delivered = 0

    def post(self, kind: str, src: int, dst: Optional[int],
             payload=None) -> int:
        """Enqueue a message; returns its global sequence number."""
        seq = next(self._seq)
        self.counters[kind] += 1
        if dst is None or src != dst:
            self.cross += 1
        else:
            self.local += 1
        self._pending.append((seq, kind, src, dst, payload))
        return seq

    def drain(self) -> int:
        """Deliver every pending message in sequence order. Returns the
        number delivered. Reentrancy-safe: a delivery that posts new
        messages extends the same drain (they still deliver in order)."""
        n = 0
        pending = self._pending
        deliver = self._deliver
        while pending:
            msg = pending.popleft()
            self.delivered += 1
            n += 1
            if deliver is not None and msg[1] in _READY_KINDS:
                deliver(msg)
        return n

    def summary(self) -> dict:
        return {"kinds": dict(self.counters), "cross": self.cross,
                "local": self.local, "delivered": self.delivered,
                "pending": len(self._pending)}


# ---------------------------------------------------------------------------
# Lease broker: per-shard quota accounts over shared devices
# ---------------------------------------------------------------------------
class LeaseAccount:
    """One shard's bandwidth lease on one shared device."""

    __slots__ = ("granted", "used")

    def __init__(self, granted: float):
        self.granted = granted   # MB/s this shard may allocate autonomously
        self.used = 0.0          # MB/s currently allocated under the lease


class LeaseBroker:
    """Per-shard bandwidth quota accounts over the shared devices.

    Each shared device's budget is split evenly at construction. A grant
    first spends the shard's own headroom; when that is short, unused grant
    is pulled from the other shards in deterministic shard order (smallest
    index first) until the need is covered — so any allocation the device
    itself could satisfy is also lease-satisfiable, and placement under
    leases is identical to placement without them. Devices the broker does
    not track (shard-private tiers) are granted trivially.

    Invariants (:meth:`check_invariants`): per shard ``0 <= used <=
    granted + eps``; per device ``sum(granted) == budget``. The property
    tests sample these at every completion of a sharded run.
    """

    def __init__(self, devices: list[StorageDevice], n_shards: int,
                 bus: Optional[ShardBus] = None):
        self.n_shards = n_shards
        self.bus = bus
        self._accounts: dict[int, tuple[StorageDevice, list[LeaseAccount]]] \
            = {}
        for dev in devices:
            share = dev.bandwidth / n_shards
            accounts = [LeaseAccount(share) for _ in range(n_shards)]
            # float-exact budget conservation: park the rounding remainder
            # on shard 0 so sum(granted) == budget bit-for-bit
            accounts[0].granted += dev.bandwidth - share * n_shards
            self._accounts[id(dev)] = (dev, accounts)
        self.grants = 0
        self.rebalances = 0
        self.denials = 0

    def tracks(self, dev: StorageDevice) -> bool:
        return id(dev) in self._accounts

    def acquire(self, shard: int, dev: StorageDevice, bw: float) -> bool:
        """Draw ``bw`` MB/s from ``shard``'s lease on ``dev`` (rebalancing
        on demand). True on success; untracked devices always succeed."""
        entry = self._accounts.get(id(dev))
        if entry is None or bw <= 0:
            return True
        accounts = entry[1]
        acct = accounts[shard]
        if acct.used + bw > acct.granted + _EPS:
            # pull unused grant from the other shards, shard order — the
            # deterministic rebalance; always covers the need when the
            # device has global headroom (the grant path checked
            # can_allocate first, so a shortfall here means a real bug)
            need = bw - (acct.granted - acct.used)
            for i in range(self.n_shards):
                if need <= _EPS:
                    break
                if i == shard:
                    continue
                other = accounts[i]
                spare = other.granted - other.used
                if spare <= _EPS:
                    continue
                take = min(spare, need)
                other.granted -= take
                acct.granted += take
                need -= take
                self.rebalances += 1
                if self.bus is not None:
                    self.bus.post(MSG_LEASE_RELEASE, i, shard,
                                  (dev.name, take))
            if acct.used + bw > acct.granted + _EPS:
                self.denials += 1
                return False
        acct.used += bw
        self.grants += 1
        if self.bus is not None:
            self.bus.post(MSG_LEASE_GRANT, shard, shard, (dev.name, bw))
        return True

    def release(self, shard: int, dev: StorageDevice, bw: float) -> None:
        entry = self._accounts.get(id(dev))
        if entry is None or bw <= 0:
            return
        acct = entry[1][shard]
        acct.used -= bw
        if acct.used < -1e-6:
            raise RuntimeError(
                f"lease accounting underflow: shard {shard} released "
                f"{bw:g} MB/s on {dev.name} it never acquired")
        if self.bus is not None:
            self.bus.post(MSG_LEASE_RELEASE, shard, shard, (dev.name, bw))

    def check_invariants(self) -> list[str]:
        """Human-readable violations; empty when consistent."""
        out = []
        for dev, accounts in self._accounts.values():
            total_granted = sum(a.granted for a in accounts)
            if abs(total_granted - dev.bandwidth) > 1e-6:
                out.append(
                    f"{dev.name}: leases sum to {total_granted:.6f} MB/s, "
                    f"budget is {dev.bandwidth:g}")
            for s, a in enumerate(accounts):
                if a.used < -1e-6:
                    out.append(f"{dev.name}: shard {s} used negative "
                               f"({a.used:.6f})")
                if a.used > a.granted + 1e-6:
                    out.append(
                        f"{dev.name}: shard {s} over-committed its lease "
                        f"(used={a.used:.6f} > granted={a.granted:.6f})")
        return out

    def summary(self) -> dict:
        devs = {}
        for dev, accounts in self._accounts.values():
            devs[dev.name] = {
                "budget": dev.bandwidth,
                "per_shard": [{"granted": a.granted, "used": a.used}
                              for a in accounts]}
        return {"grants": self.grants, "rebalances": self.rebalances,
                "denials": self.denials, "devices": devs}


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------
class ShardedScheduler:
    """N ordinary sub-schedulers behind the external scheduler interface.

    Construction splits the cluster into contiguous worker blocks (device
    objects shared, accounting global), gives every sub-scheduler the SAME
    readiness counter, launch log, completed list, running set and
    capacity-demand dict, and wires the lease broker's shard accounts into
    each sub-scheduler's grant path. ``n_shards=1`` is the plain scheduler
    with one extra (empty) bus drain per pass — bit-identical logs.
    """

    def __init__(self, cluster: Cluster,
                 launch: Callable,
                 n_shards: int,
                 scheduler_cls=Scheduler):
        self.cluster = cluster
        self.n_shards = n_shards
        self.n_workers = len(cluster.workers)
        self.bus = ShardBus(n_shards, deliver=self._deliver)
        self.broker = LeaseBroker(shared_devices(cluster, n_shards),
                                  n_shards, bus=self.bus)
        self.shards: list[Scheduler] = [
            scheduler_cls(sub, launch)
            for sub in partition_cluster(cluster, n_shards)]
        # shared identity state: ONE readiness order, ONE launch log, ONE
        # completion stream — the merged views the runtime/backend consume
        # are the primary structures, not reconciled copies
        shared_seq = itertools.count()
        self.launch_log: list = []
        self.completed: list = []
        self.running: set = set()
        self.capacity_blocked: dict = {}
        for i, s in enumerate(self.shards):
            s._ready_seq = shared_seq
            s.launch_log = self.launch_log
            s.completed = self.completed
            s.running = self.running
            s.capacity_blocked = self.capacity_blocked
            s.shard_id = i
            s.shard_lease = self.broker
        self._rr = itertools.count()     # worker round-robin (routing)
        self._fanout_src = 0             # shard of the last completed task
        self._fanout_failed = False

    # ------------------------------------------------------------- routing
    def route(self, task: TaskInstance) -> int:
        """Owning shard for ``task`` (called once, at submission): explicit
        ``shard_key=`` anchor, else first Future input's producer shard,
        else round-robin over workers."""
        key = task.shard_key
        if key is not None:
            return shard_of_worker(anchor_worker(key, self.n_workers),
                                   self.n_workers, self.n_shards)
        for a in task.args:
            for fut in iter_futures(a):
                return fut.task.shard
        for a in task.kwargs.values():
            for fut in iter_futures(a):
                return fut.task.shard
        widx = next(self._rr) % self.n_workers
        return shard_of_worker(widx, self.n_workers, self.n_shards)

    # ----------------------------------------------------------- readiness
    def _deliver(self, msg) -> None:
        task = msg[4]
        self.shards[task.shard].make_ready(task)

    def make_ready(self, task: TaskInstance) -> None:
        """Readiness at submission or retry re-queue: the message
        originates at the task's own shard (no dependency edge crossed)."""
        self.bus.post(MSG_DEP_DONE, task.shard, task.shard, task)
        self.bus.drain()

    def make_ready_many(self, tasks) -> None:
        """Completion fan-out: newly-ready children, in submission order.
        Each message's source is the shard of the task whose completion
        (or failure) satisfied the last dependency — posted as a batch,
        then drained, so delivery order matches the unsharded scheduler's
        batch order exactly."""
        kind = MSG_DEP_FAILED if self._fanout_failed else MSG_DEP_DONE
        src = self._fanout_src
        for t in tasks:
            self.bus.post(kind, src, t.shard, t)
        self.bus.drain()

    # ---------------------------------------------------------- scheduling
    def schedule_pass(self) -> int:
        self.bus.drain()   # any posted update is visible before decisions
        shards = self.shards
        if not any(s._dirty for s in shards):
            return 0
        launched = 0
        while True:
            n = self._round()
            launched += n
            if n == 0:
                break
        for s in shards:
            s._dirty = False
        return launched

    def _round(self) -> int:
        """One global-order round: a single heap over every shard's class
        heads, keyed by the shared readiness sequence — the exact attempt
        order the unsharded scheduler's round uses, with each attempt
        confined to the owning shard's workers."""
        heads = [(q[0]._ready_seq, i, key)
                 for i, s in enumerate(self.shards) if s._ready_count
                 for key, q in s._ready_q.items() if q]
        heapq.heapify(heads)
        launched = 0
        while heads:
            _, i, key = heapq.heappop(heads)
            s = self.shards[i]
            if s._attempt_head(key):
                launched += 1
                q = s._ready_q.get(key)
                if q:
                    heapq.heappush(heads, (q[0]._ready_seq, i, key))
        return launched

    # ---------------------------------------------------------- completion
    def on_complete(self, task: TaskInstance) -> None:
        self._fanout_src = task.shard
        self._fanout_failed = task.state == TaskState.FAILED
        self.shards[task.shard].on_complete(task)

    def on_retry(self, task: TaskInstance) -> None:
        self.shards[task.shard].on_retry(task)

    def end_of_stream(self) -> None:
        for s in self.shards:
            s.end_of_stream()

    def assert_not_stuck(self) -> None:
        if self.n_ready and not self.running:
            self.end_of_stream()
            self._dirty = True
            if self.schedule_pass() == 0 and self.n_ready \
                    and not self.running:
                names = [t.defn.name for t in self.ready[:5]]
                raise SchedulerError(
                    f"scheduler stuck: {self.n_ready} ready tasks "
                    f"(e.g. {names}) across {self.n_shards} shards but "
                    f"nothing running/placeable")

    # ------------------------------------------------------------- wiring
    def validate_submit(self, task: TaskInstance) -> None:
        # validated against the owning shard's sub-cluster: confinement
        # means a class its shard can never satisfy IS unsatisfiable for
        # this task, even if another shard's workers could take it
        self.shards[task.shard].validate_submit(task)

    def set_tuning(self, drift=None, tier_objective: bool = False) -> None:
        for s in self.shards:
            s.set_tuning(drift=drift, tier_objective=tier_objective)

    def set_recorder(self, recorder) -> None:
        # one recorder, every shard: sub-scheduler events interleave in
        # call order, which the global-order round makes deterministic —
        # the merged stream needs no post-hoc reconciliation
        for s in self.shards:
            s.set_recorder(recorder)

    def set_catalog(self, catalog) -> None:
        catalog.shardbus = self.bus
        for s in self.shards:
            s.set_catalog(catalog)

    # ------------------------------------------------------- merged views
    @property
    def _dirty(self) -> bool:
        return any(s._dirty for s in self.shards)

    @_dirty.setter
    def _dirty(self, value: bool) -> None:
        for s in self.shards:
            s._dirty = value

    @property
    def recorder(self):
        return self.shards[0].recorder

    @property
    def catalog(self):
        return self.shards[0].catalog

    @property
    def n_ready(self) -> int:
        return sum(s._ready_count for s in self.shards)

    def n_ready_of(self, sig: str) -> int:
        return sum(s.n_ready_of(sig) for s in self.shards)

    @property
    def ready(self) -> list:
        tasks = [t for s in self.shards for q in s._ready_q.values()
                 for t in q]
        tasks.sort(key=lambda t: t._ready_seq)
        return tasks

    @property
    def tuners(self) -> dict:
        """Merged tuner view: plain keys with one shard (drop-in for the
        unsharded scheduler), ``key#s<i>`` suffixes otherwise (two shards
        may each calibrate the same signature independently)."""
        if self.n_shards == 1:
            return self.shards[0].tuners
        out = {}
        for i, s in enumerate(self.shards):
            for key, tuner in s.tuners.items():
                out[f"{key}#s{i}"] = tuner
        return out

    def summary(self) -> dict:
        """Control-plane rollup for ``rt.stats()["shards"]``."""
        per_shard = []
        for i, s in enumerate(self.shards):
            per_shard.append({
                "workers": [w.name for w in s.cluster.workers],
                "n_launched": sum(1 for t in self.completed
                                  if t.shard == i),
                "n_ready": s._ready_count,
                "n_tuners": len(s.tuners),
            })
        return {"n_shards": self.n_shards, "per_shard": per_shard,
                "bus": self.bus.summary(), "leases": self.broker.summary(),
                "lease_violations": self.broker.check_invariants()}
