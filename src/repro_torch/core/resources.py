"""Resource descriptions: workers, storage tiers, bandwidth accounting.

Mirrors the COMPSs resource-description file (paper §4.1.2) extended with a
maximum I/O bandwidth per storage device (paper §4.2.2), generalised to a
**multi-tier storage hierarchy**: each worker carries an *ordered* list of
tiers (fastest first), each tier its own :class:`StorageDevice` with an
independent bandwidth budget and congestion calibration. The paper's
single-device MareNostrum-4 setup is the one-tier special case
(:meth:`Cluster.make`); :meth:`Cluster.make_tiered` builds the
SSD → burst-buffer → shared-FS layering of modern HPC platforms.

Tier model
----------
* ``WorkerNode.tiers`` is ordered fastest-first; ``WorkerNode.storage`` is an
  alias for ``tiers[0]`` (the node-local device) so single-tier code — and
  the frozen seed scheduler in ``benchmarks/_seed_impl.py`` — is unchanged.
* A :class:`StorageDevice` may be *shared* between workers simply by placing
  the same instance in several tier lists (the burst buffer and the shared
  filesystem below); bandwidth is always accounted per *device*, so a shared
  tier is a single budget no matter how many workers reference it.
* ``StorageDevice.tier`` is the tier label tasks target via the ``tier=``
  hint on ``@constraint`` or the per-call ``storage_tier=`` override
  (see ``runtime.py``); the scheduler's default policy is label-free:
  prefer the fastest tier with budget, fall back down the hierarchy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class StorageDevice:
    """A storage device with a bandwidth budget for constraint accounting.

    ``bandwidth`` is the budget the scheduler allocates constraint values
    from (MB/s). The congestion model parameters describe how the *achieved*
    aggregate throughput behaves as a function of the number of concurrent
    streams (see storage_model.py); they drive the simulator and default to
    the MareNostrum-4 node-local SSD calibration from the paper. Each tier of
    a hierarchy is its own device with its own calibration.
    """

    name: str
    bandwidth: float = 450.0        # MB/s, budget for storageBW accounting
    per_stream_cap: float = 8.0     # MB/s a single stream can achieve
    congestion_alpha: float = 0.004  # linear penalty per stream past the knee
    congestion_beta: float = 1e-5   # quadratic term: fsync seek-thrash at
    #                                 very high concurrency is superlinear
    congestion_knee: Optional[int] = None  # default: bandwidth/per_stream_cap
    tier: str = "ssd"               # tier label (targetable via tier= hints)
    capacity_gb: Optional[float] = None  # finite capacity budget; None =
    #                                      unlimited (the seed behaviour)

    def __post_init__(self):
        if self.capacity_gb is not None and self.capacity_gb <= 0:
            raise ValueError(
                f"device {self.name}: capacity_gb must be positive "
                f"(got {self.capacity_gb}); use capacity_gb=None for an "
                f"unlimited tier")
        if self.bandwidth <= 0:
            raise ValueError(
                f"device {self.name}: bandwidth must be positive "
                f"(got {self.bandwidth})")
        if self.congestion_knee is None:
            self.congestion_knee = max(1, int(self.bandwidth / self.per_stream_cap))
        # --- dynamic accounting state ---
        self.available_bw: float = self.bandwidth
        self.active_io: int = 0          # running I/O tasks on this device
        self.bytes_written: float = 0.0  # MB, for throughput reporting
        self.rate_epoch: int = 0         # bumped whenever active_io changes:
        #                                  the O(1) "did this device's rate
        #                                  change" check for rate caches
        self.release_epoch: int = 0      # bumped on releases only — the sole
        #                                  rate-RAISING change, i.e. the only
        #                                  one that can make cached finish-time
        #                                  lower bounds stale-late
        # --- capacity occupancy state (symmetric to the bandwidth budget:
        #     reserve-at-grant, commit-at-finish, free-at-eviction) ---
        self.used_mb: float = 0.0        # committed resident bytes (MB)
        self.reserved_mb: float = 0.0    # in-flight writer reservations (MB)
        self.peak_occupancy_mb: float = 0.0  # high-water mark of used+reserved
        # --- co-tenant (background) traffic state (interference.py) ---
        # Background streams share the congestion model fairly with our
        # tasks; background bandwidth/capacity claims are clamped to the
        # free budget so a co-tenant can never over-commit the device.
        self.background_streams: int = 0
        self.background_bw: float = 0.0  # MB/s currently held by co-tenants
        self.background_mb: float = 0.0  # capacity currently held (MB)
        # --- failure-domain health state (failures.py) ---
        # healthy -> degraded(bw_factor) -> offline, driven by a
        # FailureSchedule; healthy keeps every accounting path (and all
        # simulator arithmetic) identical to a pre-failure-domain device.
        self.health: str = "healthy"
        self.bw_factor: float = 1.0      # effective-bandwidth fraction
        #                                  while degraded (1.0 otherwise)
        # memoized per-task-rate curve (storage_model.per_task_rate):
        # k -> MB/s, valid while calibration and health are unchanged
        self._rate_cache: dict = {}

    def invalidate_rates(self) -> None:
        """Drop the memoized T(k) curve. Must be called after any mutation
        of the congestion calibration (bandwidth, per_stream_cap, alpha,
        beta, knee — see obs.telemetry.apply_tier_config) or of the health
        state; population changes (active_io, background_streams) need no
        invalidation because they are the ``k`` argument, not cached
        state."""
        self._rate_cache.clear()

    # -- failure-domain health (failures.py) ---------------------------------
    @property
    def effective_bandwidth(self) -> float:
        """The bandwidth the device can actually deliver in its current
        health state: 0 offline, ``bw_factor * bandwidth`` degraded."""
        if self.health == "offline":
            return 0.0
        return self.bandwidth * self.bw_factor

    def set_health(self, state: str, bw_factor: float = 1.0) -> None:
        """Transition the device's health. Any transition can change the
        achievable rate in either direction, so both epochs bump — the
        simulator re-checks every cached finish-time estimate."""
        if state not in ("healthy", "degraded", "offline"):
            raise ValueError(f"unknown health state {state!r}")
        if state == "degraded":
            if not (0.0 < bw_factor <= 1.0):
                raise ValueError(
                    f"degraded bw_factor must be in (0, 1], got {bw_factor}")
            self.bw_factor = bw_factor
        else:
            self.bw_factor = 1.0
        self.health = state
        self.invalidate_rates()
        self.rate_epoch += 1
        self.release_epoch += 1

    # -- budget accounting (scheduler-facing) --------------------------------
    def can_allocate(self, bw: float) -> bool:
        if self.health == "healthy":
            return bw <= self.available_bw + 1e-9
        if self.health == "offline":
            return False
        # degraded: the lost fraction of the nameplate budget is not
        # allocatable — grants must fit under what the device can deliver
        lost = self.bandwidth - self.effective_bandwidth
        return bw <= self.available_bw - lost + 1e-9

    def allocate(self, bw: float) -> None:
        if not self.can_allocate(bw):
            raise RuntimeError(
                f"over-allocating device {self.name}: want {bw}, have {self.available_bw}")
        self.available_bw -= bw
        self.active_io += 1
        self.rate_epoch += 1

    def release(self, bw: float) -> None:
        self.available_bw += bw
        self.active_io -= 1
        self.rate_epoch += 1
        self.release_epoch += 1
        if self.active_io < 0 or self.available_bw > self.bandwidth + 1e-6:
            raise RuntimeError(f"bandwidth accounting underflow on {self.name}")

    # -- co-tenant (background) traffic (interference.py) --------------------
    def add_background(self, streams: int, bw: float) -> float:
        """A co-tenant burst arrives: it joins the congestion model with
        ``streams`` fair-share streams and takes up to ``bw`` MB/s out of
        the allocatable budget — clamped to what is actually free, so the
        scheduler's own grants are never invalidated. Returns the bandwidth
        actually taken (pass it back to :meth:`remove_background`)."""
        headroom = self.available_bw
        if self.health == "offline":
            headroom = 0.0
        elif self.health == "degraded":
            headroom = max(
                0.0, headroom - (self.bandwidth - self.effective_bandwidth))
        taken = min(max(bw, 0.0), headroom)
        self.available_bw -= taken
        self.background_bw += taken
        self.background_streams += max(int(streams), 0)
        self.rate_epoch += 1
        return taken

    def remove_background(self, streams: int, bw_taken: float) -> None:
        """The burst ends: streams leave and the taken bandwidth returns.
        A departure raises per-task rates, so the release epoch bumps (the
        simulator refreshes its finish-time lower bounds on it)."""
        self.available_bw += bw_taken
        self.background_bw -= bw_taken
        self.background_streams -= max(int(streams), 0)
        self.rate_epoch += 1
        self.release_epoch += 1
        if self.background_streams < 0 or self.background_bw < -1e-6 \
                or self.available_bw > self.bandwidth + 1e-6:
            raise RuntimeError(
                f"background traffic accounting underflow on {self.name}")

    def add_background_capacity(self, mb: float) -> float:
        """A co-tenant fills capacity (e.g. its own checkpoints landing on
        the shared burst buffer). Clamped to the free space — the co-tenant
        cannot overfill the device, but by shrinking free capacity it can
        push occupancy over the eviction watermarks and capacity-block our
        grants. Returns the MB actually taken."""
        if self.capacity_gb is None or mb <= 0 or self.health == "offline":
            return 0.0
        taken = min(mb, self.free_capacity_mb())
        if taken <= 0:
            return 0.0
        self.background_mb += taken
        self.peak_occupancy_mb = max(self.peak_occupancy_mb, self.occupancy_mb)
        return taken

    def remove_background_capacity(self, mb_taken: float) -> None:
        if mb_taken <= 0:
            return
        self.background_mb -= mb_taken
        if self.background_mb < -1e-6:
            raise RuntimeError(
                f"background capacity underflow on {self.name}")

    # -- capacity occupancy (data lifecycle; see datalife.py) ----------------
    @property
    def capacity_mb(self) -> Optional[float]:
        return None if self.capacity_gb is None else self.capacity_gb * 1024.0

    @property
    def occupancy_mb(self) -> float:
        """Committed + in-flight-reserved + co-tenant occupancy (MB)."""
        return self.used_mb + self.reserved_mb + self.background_mb

    def free_capacity_mb(self) -> float:
        cap = self.capacity_mb
        if cap is None:
            return float("inf")
        return cap - self.occupancy_mb

    def can_reserve_capacity(self, mb: float) -> bool:
        return mb <= self.free_capacity_mb() + 1e-9

    def reserve_capacity(self, mb: float) -> None:
        """Reserve-at-grant: an I/O task granted on this device claims its
        output footprint up front so concurrent grants can't overcommit."""
        if mb <= 0 or self.capacity_gb is None:
            return
        if not self.can_reserve_capacity(mb):
            raise RuntimeError(
                f"over-filling device {self.name}: want {mb} MB, have "
                f"{self.free_capacity_mb():.1f} MB free of "
                f"{self.capacity_mb:.0f}")
        self.reserved_mb += mb
        self.peak_occupancy_mb = max(self.peak_occupancy_mb, self.occupancy_mb)

    def commit_capacity(self, mb: float) -> None:
        """Commit-at-finish: the reservation becomes resident data."""
        if mb <= 0 or self.capacity_gb is None:
            return
        self.reserved_mb -= mb
        self.used_mb += mb
        if self.reserved_mb < -1e-6:
            raise RuntimeError(f"capacity reservation underflow on {self.name}")

    def cancel_reservation(self, mb: float) -> None:
        """A granted writer failed: its reservation never becomes resident."""
        if mb <= 0 or self.capacity_gb is None:
            return
        self.reserved_mb -= mb
        if self.reserved_mb < -1e-6:
            raise RuntimeError(f"capacity reservation underflow on {self.name}")

    def free_capacity(self, mb: float) -> None:
        """Eviction/deletion: resident data leaves the device."""
        if mb <= 0 or self.capacity_gb is None:
            return
        self.used_mb -= mb
        if self.used_mb < -1e-6:
            raise RuntimeError(f"capacity occupancy underflow on {self.name}")

    def check_invariants(self) -> list:
        """Read-only audit of the accounting state, returning human-readable
        violation messages (empty when consistent). Driven by the inline
        sanitizer (repro.analysis.sanitizer) at every simulation event
        boundary; the runtime's own accounting methods raise eagerly on the
        underflows they can see locally — this catches cross-counter drift
        they can't."""
        eps = 1e-6
        out = []
        if self.available_bw < -eps:
            out.append(
                f"{self.name}: bandwidth over-committed "
                f"(available_bw={self.available_bw:.6f} MB/s)")
        if self.available_bw > self.bandwidth + eps:
            out.append(
                f"{self.name}: bandwidth over-released "
                f"(available_bw={self.available_bw:.6f} exceeds budget "
                f"{self.bandwidth:g} MB/s)")
        if self.active_io < 0:
            out.append(f"{self.name}: active_io negative ({self.active_io})")
        if self.background_streams < 0 or self.background_bw < -eps \
                or self.background_mb < -eps:
            out.append(
                f"{self.name}: background traffic accounting negative "
                f"(streams={self.background_streams}, "
                f"bw={self.background_bw:.6f}, mb={self.background_mb:.6f})")
        if self.used_mb < -eps or self.reserved_mb < -eps:
            out.append(
                f"{self.name}: capacity accounting negative "
                f"(used_mb={self.used_mb:.6f}, "
                f"reserved_mb={self.reserved_mb:.6f})")
        cap = self.capacity_mb
        if cap is not None and self.occupancy_mb > cap + eps:
            out.append(
                f"{self.name}: occupancy {self.occupancy_mb:.3f} MB exceeds "
                f"capacity {cap:.0f} MB (used={self.used_mb:.3f}, "
                f"reserved={self.reserved_mb:.3f}, "
                f"background={self.background_mb:.3f})")
        if self.health not in ("healthy", "degraded", "offline"):
            out.append(f"{self.name}: unknown health state {self.health!r}")
        if not (0.0 < self.bw_factor <= 1.0):
            out.append(
                f"{self.name}: bw_factor {self.bw_factor} outside (0, 1]")
        if self.health == "offline" and self.active_io > 0:
            out.append(
                f"{self.name}: offline device still has "
                f"{self.active_io} active I/O task(s) — in-flight work "
                f"must fail into the retry path on transition")
        return out

    def reset(self):
        self.available_bw = self.bandwidth
        self.active_io = 0
        self.bytes_written = 0.0
        self.invalidate_rates()
        self.rate_epoch += 1
        self.release_epoch += 1
        self.used_mb = 0.0
        self.reserved_mb = 0.0
        self.peak_occupancy_mb = 0.0
        self.background_streams = 0
        self.background_bw = 0.0
        self.background_mb = 0.0
        self.health = "healthy"
        self.bw_factor = 1.0


@dataclass
class WorkerNode:
    """A worker with a compute execution platform and an I/O execution
    platform (paper Fig. 7), fronting an ordered storage hierarchy.

    ``tiers`` lists the storage devices reachable from this node, fastest
    first; ``storage`` stays the legacy alias for ``tiers[0]``. Constructing
    with only ``storage=`` (or nothing) yields the paper's one-tier node.
    """

    name: str
    cpus: int = 48
    io_executors: int = 225
    storage: StorageDevice = None  # node-local device (alias for tiers[0])
    tiers: list = None             # ordered hierarchy, fastest first

    def __post_init__(self):
        if self.tiers is None:
            if self.storage is None:
                self.storage = StorageDevice(name=f"{self.name}-ssd")
            self.tiers = [self.storage]
        else:
            if not self.tiers:
                raise ValueError(f"worker {self.name}: tiers must be non-empty")
            if self.storage is not None and self.storage is not self.tiers[0]:
                raise ValueError(
                    f"worker {self.name}: storage= and tiers[0] disagree — "
                    f"pass one or the other")
            self.storage = self.tiers[0]
        self.free_cpus: int = self.cpus
        self.free_io_executors: int = self.io_executors
        self.learning_owner = None   # signature owning this node as an
        #                              active-learning node (paper §4.2.3B)

    def tier_device(self, tier: str) -> Optional[StorageDevice]:
        """The device backing tier label ``tier`` on this node, or None."""
        for d in self.tiers:
            if d.tier == tier:
                return d
        return None

    def reset(self):
        self.free_cpus = self.cpus
        self.free_io_executors = self.io_executors
        self.learning_owner = None
        for d in self.tiers:
            d.reset()


@dataclass
class Cluster:
    """The resource pool the scheduler draws from.

    ``shared_workdir`` mirrors the paper: when True, task outputs live on a
    shared FS so I/O tasks go to the first candidate node; when False the
    scheduler prefers data locality.
    """

    workers: list = field(default_factory=list)
    shared_workdir: bool = True

    @staticmethod
    def make(n_workers: int = 12, cpus: int = 48, io_executors: int = 225,
             device_bw: float = 450.0, per_stream_cap: float = 8.0,
             congestion_alpha: float = 0.004,
             shared_storage: bool = False) -> "Cluster":
        """Build the paper's 12-node MareNostrum-4-like cluster by default."""
        shared_dev = StorageDevice(
            name="shared-fs", bandwidth=device_bw,
            per_stream_cap=per_stream_cap,
            congestion_alpha=congestion_alpha,
            tier="fs") if shared_storage else None
        workers = []
        for i in range(n_workers):
            dev = shared_dev or StorageDevice(
                name=f"w{i}-ssd", bandwidth=device_bw,
                per_stream_cap=per_stream_cap,
                congestion_alpha=congestion_alpha)
            workers.append(WorkerNode(
                name=f"w{i}", cpus=cpus, io_executors=io_executors, storage=dev))
        return Cluster(workers=workers)

    @staticmethod
    def make_tiered(n_workers: int = 12, cpus: int = 48,
                    io_executors: int = 225,
                    ssd_bw: float = 450.0, ssd_stream_cap: float = 8.0,
                    bb_bw: float = 1600.0, bb_stream_cap: float = 40.0,
                    fs_bw: float = 300.0, fs_stream_cap: float = 4.0,
                    congestion_alpha: float = 0.004,
                    ssd_capacity_gb: Optional[float] = None,
                    bb_capacity_gb: Optional[float] = None,
                    fs_capacity_gb: Optional[float] = None) -> "Cluster":
        """Three-tier hierarchy: node-local SSD → shared burst buffer →
        shared parallel FS.

        The SSD tier is one device *per worker* (as in :meth:`make`); the
        burst buffer and the shared FS are each a single shared device
        referenced by every worker, so their budgets are cluster-global.
        Defaults sketch a DataWarp-like burst buffer (high aggregate
        bandwidth, generous per-stream rate) over a congested parallel FS
        (modest aggregate bandwidth shared by everyone).

        ``*_capacity_gb`` gives the tier a finite capacity budget (per
        device: each worker SSD individually, the shared bb/fs globally);
        None keeps the tier unlimited — the data lifecycle subsystem
        (datalife.py) activates whenever any tier is finite.
        """
        bb = StorageDevice(name="burst-buffer", bandwidth=bb_bw,
                           per_stream_cap=bb_stream_cap,
                           congestion_alpha=congestion_alpha, tier="bb",
                           capacity_gb=bb_capacity_gb)
        fs = StorageDevice(name="shared-fs", bandwidth=fs_bw,
                           per_stream_cap=fs_stream_cap,
                           congestion_alpha=congestion_alpha, tier="fs",
                           capacity_gb=fs_capacity_gb)
        workers = []
        for i in range(n_workers):
            ssd = StorageDevice(name=f"w{i}-ssd", bandwidth=ssd_bw,
                                per_stream_cap=ssd_stream_cap,
                                congestion_alpha=congestion_alpha, tier="ssd",
                                capacity_gb=ssd_capacity_gb)
            workers.append(WorkerNode(
                name=f"w{i}", cpus=cpus, io_executors=io_executors,
                tiers=[ssd, bb, fs]))
        return Cluster(workers=workers)

    @property
    def devices(self):
        seen, out = set(), []
        for w in self.workers:
            for d in w.tiers:
                if id(d) not in seen:
                    seen.add(id(d))
                    out.append(d)
        return out

    def tier_names(self) -> list:
        """Distinct tier labels present in the cluster, hierarchy order."""
        seen, out = set(), []
        for w in self.workers:
            for d in w.tiers:
                if d.tier not in seen:
                    seen.add(d.tier)
                    out.append(d.tier)
        return out

    def has_tier(self, tier: str) -> bool:
        return any(w.tier_device(tier) is not None for w in self.workers)

    def tier_spec(self, tier: str) -> Optional[StorageDevice]:
        """A representative device for ``tier`` (the first worker's), used
        for analytic estimates like cross-tier read floors."""
        for w in self.workers:
            d = w.tier_device(tier)
            if d is not None:
                return d
        return None

    def reset(self):
        for w in self.workers:
            w.reset()

    def total_cpus(self) -> int:
        return sum(w.cpus for w in self.workers)
