"""Static I/O-plan rule engine: structured diagnostics over a captured DAG.

Diagnostic codes are stable API (tests and docs/lint.md key on them):

=========  ===============  ====================================================
code       category         condition
=========  ===============  ====================================================
``IO101``  constraints      static storageBW exceeds every eligible device
``IO102``  constraints      tier pin names a tier absent from the cluster
``IO103``  constraints      computingUnits exceed every worker's cpus
``IO104``  constraints      bounded auto minimum exceeds every eligible device
``IO201``  capacity         object larger than every eligible tier's capacity
``IO202``  capacity         unevictable footprint exceeds a finite tier
``IO203``  capacity         pin without a matching unpin (capacity leak)
``IO204``  capacity         finite durable tier with auto-evict (wedge)
``IO301``  race/ordering    two unordered tasks touch the same path
``IO302``  race/ordering    task reads a future after ``rt.discard`` of it
``IO303``  race/ordering    drain/prefetch with no producer dependency
``IO304``  race/ordering    manifest/commit not ordered after its shards
``IO401``  determinism      unseeded ``BurstyTraffic`` (irreproducible runs)
``IO402``  determinism      task body references an unseeded RNG source
``IO501``  failure-domains  schedule leaves the durable tier offline forever
``IO601``  sharding         dependency chain ping-pongs across shard anchors
``IO602``  sharding         shared-tier output fanned out to many shard anchors
=========  ===============  ====================================================

Feasibility predicates are shared with the scheduler
(:func:`repro.core.scheduler.eligible_devices`), so a lint diagnostic and a
submission-time ``SchedulerError`` can never disagree about what is
placeable. Full fidelity requires capture mode
(``IORuntime(backend="capture")``); linting a live runtime still runs every
rule but sees only the edges ``TaskGraph`` retained.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

from ..core.constraints import AutoSpec, StaticSpec
from ..core.graph import bind_args, iter_futures
from ..core.interference import BurstyTraffic
from ..core.scheduler import eligible_devices
from ..core.task import TaskInstance, TaskType

CATEGORIES = {"1": "constraints", "2": "capacity", "3": "race/ordering",
              "4": "determinism", "5": "failure-domains", "6": "sharding"}

_MOVER_SIGS = ("tier_drain", "tier_prefetch")


@dataclass(frozen=True)
class Diagnostic:
    """One structured finding. ``task``/``tid`` name the offending task
    (None for cluster/config-level findings like IO204/IO401)."""

    code: str
    message: str
    task: Optional[str] = None
    tid: Optional[int] = None

    @property
    def category(self) -> str:
        return CATEGORIES.get(self.code[2:3], "other")

    def __str__(self) -> str:
        loc = f" [{self.task}#{self.tid}]" if self.task is not None else ""
        return f"{self.code} ({self.category}){loc}: {self.message}"


def _diag(code: str, message: str, task: Optional[TaskInstance] = None
          ) -> Diagnostic:
    if task is None:
        return Diagnostic(code, message)
    return Diagnostic(code, message, task=task.defn.signature, tid=task.tid)


# --------------------------------------------------------------------------
# Analysis context
# --------------------------------------------------------------------------
class _Ctx:
    """Uniform view over a captured plan (full edges) or a live runtime's
    graph (partial edges: only those unfinished at submission)."""

    def __init__(self, rt):
        self.rt = rt
        self.cluster = rt.cluster
        self.catalog = rt.catalog
        cap = getattr(rt.backend, "capture", None)
        self.capture = cap
        if cap is not None:
            self.tasks = list(cap.tasks)
            self.edges = cap.edges
            self.future_inputs = cap.future_inputs
        else:
            self.tasks = [rt.graph.tasks[tid]
                          for tid in sorted(rt.graph.tasks)]
            self.edges = {t.tid: {d: True for d in t.deps}
                          for t in self.tasks}
            self.future_inputs = {}
            for t in self.tasks:
                futs = set()
                for arg in list(t.args) + list(t.kwargs.values()):
                    for f in iter_futures(arg):
                        futs.add(f.task.tid)
                self.future_inputs[t.tid] = futs
        self._order_cache: dict[tuple[int, int], bool] = {}

    def ordered_before(self, a: int, b: int) -> bool:
        """True iff task ``a`` happens-before ``b`` through recorded edges
        (data and anti edges both order). On-demand BFS with memo — the
        candidate pairs rules ask about are few, so no transitive closure
        is materialised."""
        if a == b:
            return True
        key = (a, b)
        hit = self._order_cache.get(key)
        if hit is not None:
            return hit
        found = False
        seen = {b}
        stack = [b]
        while stack:
            cur = stack.pop()
            for pred in self.edges.get(cur, ()):
                if pred == a:
                    found = True
                    stack.clear()
                    break
                if pred > a and pred not in seen:  # edges point to lower tids
                    seen.add(pred)
                    stack.append(pred)
        self._order_cache[key] = found
        return found

    def io_tasks(self) -> Iterator[TaskInstance]:
        for t in self.tasks:
            if t.defn.task_type != TaskType.COMPUTE:
                yield t


def _tier_suffix(tier: Optional[str]) -> str:
    return f" on tier {tier!r}" if tier is not None else ""


# --------------------------------------------------------------------------
# IO1xx — constraint satisfiability
# --------------------------------------------------------------------------
def _rule_io101_static_bw(ctx: _Ctx) -> Iterator[Diagnostic]:
    seen = set()
    for t in ctx.io_tasks():
        spec = t.storage_bw
        if not isinstance(spec, StaticSpec):
            continue
        tier = t.tier
        if tier is not None and not ctx.cluster.has_tier(tier):
            continue  # IO102 reports the unknown tier
        key = (t.defn.signature, spec.value, tier)
        if key in seen:
            continue
        seen.add(key)
        devs = eligible_devices(ctx.cluster, tier)
        if devs and all(d.bandwidth < spec.value for d in devs):
            cap = max(d.bandwidth for d in devs)
            yield _diag("IO101",
                        f"storageBW={spec.value:g} MB/s exceeds every "
                        f"eligible device's bandwidth"
                        f"{_tier_suffix(tier)} (max {cap:g} MB/s) — the "
                        f"task can never be granted", t)


def _rule_io102_unknown_tier(ctx: _Ctx) -> Iterator[Diagnostic]:
    seen = set()
    for t in ctx.tasks:
        tier = t.tier
        if tier is None or ctx.cluster.has_tier(tier):
            continue
        key = (t.defn.signature, tier)
        if key in seen:
            continue
        seen.add(key)
        yield _diag("IO102",
                    f"storage tier {tier!r} is not present on any worker "
                    f"(available: {ctx.cluster.tier_names()})", t)


def _rule_io103_cpu_units(ctx: _Ctx) -> Iterator[Diagnostic]:
    workers = ctx.cluster.workers
    if not workers:
        return
    max_cpus = max(w.cpus for w in workers)
    seen = set()
    for t in ctx.tasks:
        if t.defn.task_type != TaskType.COMPUTE:
            continue
        cu = t.defn.computing_units
        if cu <= max_cpus or t.defn.signature in seen:
            continue
        seen.add(t.defn.signature)
        yield _diag("IO103",
                    f"computingUnits={cu} exceeds every worker's cpus "
                    f"(max {max_cpus}) — the task can never be placed", t)


def _rule_io104_auto_min(ctx: _Ctx) -> Iterator[Diagnostic]:
    seen = set()
    for t in ctx.io_tasks():
        spec = t.storage_bw
        if not isinstance(spec, AutoSpec) or not spec.bounded:
            continue
        tier = t.tier
        if tier is not None and not ctx.cluster.has_tier(tier):
            continue
        key = (t.defn.signature, spec.min, tier)
        if key in seen:
            continue
        seen.add(key)
        devs = eligible_devices(ctx.cluster, tier)
        if devs and all(d.bandwidth < spec.min for d in devs):
            cap = max(d.bandwidth for d in devs)
            yield _diag("IO104",
                        f"auto constraint lower bound min={spec.min:g} MB/s "
                        f"exceeds every eligible device's bandwidth"
                        f"{_tier_suffix(tier)} (max {cap:g} MB/s) — no "
                        f"learning epoch can ever be granted", t)


# --------------------------------------------------------------------------
# IO2xx — capacity / lifecycle
# --------------------------------------------------------------------------
def _capacity_enforced(ctx: _Ctx) -> bool:
    return ctx.catalog is not None and ctx.catalog.enabled


def _rule_io201_oversized_object(ctx: _Ctx) -> Iterator[Diagnostic]:
    if not _capacity_enforced(ctx):
        return
    seen = set()
    for t in ctx.io_tasks():
        mb = t.sim.io_bytes
        if mb <= 0:
            continue
        tier = t.tier
        if tier is not None and not ctx.cluster.has_tier(tier):
            continue
        key = (t.defn.signature, mb, tier)
        if key in seen:
            continue
        seen.add(key)
        devs = eligible_devices(ctx.cluster, tier)
        caps = [d.capacity_mb for d in devs]
        if caps and all(c is not None and mb > c for c in caps):
            yield _diag("IO201",
                        f"output footprint io_mb={mb:g} exceeds every "
                        f"eligible device's total capacity"
                        f"{_tier_suffix(tier)} (max "
                        f"{max(caps):.0f} MB) — not grantable even after "
                        f"evicting everything", t)


def _rule_io202_unevictable_footprint(ctx: _Ctx) -> Iterator[Diagnostic]:
    if not _capacity_enforced(ctx):
        return
    cat = ctx.catalog
    auto_evict = cat.config.auto_evict
    pinned_tids = set()
    if ctx.capture is not None:
        for fut in ctx.capture.pins.values():
            pinned_tids.add(fut.task.tid)
    per_tier: dict[str, float] = {}
    first: dict[str, TaskInstance] = {}
    for t in ctx.io_tasks():
        mb = t.sim.io_bytes
        tier = t.tier
        if mb <= 0 or tier is None or not ctx.cluster.has_tier(tier):
            continue
        if t.defn.signature in _MOVER_SIGS:
            continue  # movements don't create new footprint on top of the
        #               payload's (the catalog aliases, not duplicates)
        if auto_evict and t.tid not in pinned_tids:
            continue  # evictable: watermark pressure can clear it
        per_tier[tier] = per_tier.get(tier, 0.0) + mb
        first.setdefault(tier, t)
    if ctx.capture is not None:
        for ext in ctx.capture.externals:
            if ext["pinned"] or not auto_evict:
                tier = ext["tier"]
                per_tier[tier] = per_tier.get(tier, 0.0) + ext["size_mb"]
    for tier, mb in sorted(per_tier.items()):
        caps = [d.capacity_mb for d in eligible_devices(ctx.cluster, tier)]
        if not caps or any(c is None for c in caps):
            continue
        total = sum(caps)
        if mb > total + 1e-6:
            why = "pinned" if auto_evict else \
                "unevictable (auto_evict is off)"
            yield _diag("IO202",
                        f"peak footprint of {why} data on tier {tier!r} "
                        f"reaches {mb:.0f} MB but the tier's total "
                        f"capacity is {total:.0f} MB — the run will wedge "
                        f"capacity-blocked", first.get(tier))


def _rule_io203_pin_leak(ctx: _Ctx) -> Iterator[Diagnostic]:
    if ctx.capture is None:
        return
    for fut in ctx.capture.pins.values():
        t = fut.task
        yield _diag("IO203",
                    f"pin without a matching unpin: the object produced by "
                    f"{t.defn.signature}#{t.tid} stays exempt from "
                    f"eviction forever (a capacity leak on its tier) — "
                    f"call rt.unpin(...) once the data stops being hot", t)


def _rule_io204_finite_durable(ctx: _Ctx) -> Iterator[Diagnostic]:
    for msg in getattr(ctx.catalog, "config_errors", ()):
        yield Diagnostic("IO204", msg)


# --------------------------------------------------------------------------
# IO3xx — races / ordering
# --------------------------------------------------------------------------
#: parameter names treated as file paths; ``src``-flavoured ones are reads,
#: everything else a write (conservative: flags write-write and write-read)
_PATH_PARAMS = {"path", "file", "filename", "fname", "dest", "dst", "out",
                "output", "target", "manifest", "src", "source"}
_READ_PARAMS = {"src", "source", "src_path", "source_path", "src_file"}


def _path_args(task: TaskInstance) -> Iterator[tuple[str, bool]]:
    """(path, is_write) for every path-like string argument."""
    for pname, arg in bind_args(task):
        if not isinstance(arg, str) or not arg:
            continue
        base = pname.lower()
        if base in _PATH_PARAMS or base.endswith(("_path", "_file", "_dir")):
            yield arg, base not in _READ_PARAMS


def _rule_io301_path_races(ctx: _Ctx) -> Iterator[Diagnostic]:
    by_path: dict[str, list[tuple[TaskInstance, bool]]] = {}
    for t in ctx.io_tasks():
        for path, is_write in _path_args(t):
            by_path.setdefault(path, []).append((t, is_write))
    for path, touches in sorted(by_path.items()):
        if len(touches) < 2:
            continue
        reported = False
        for i in range(len(touches)):
            if reported:
                break
            a, a_w = touches[i]
            for b, b_w in touches[i + 1:]:
                if a.tid == b.tid or not (a_w or b_w):
                    continue  # read-read never races
                lo, hi = (a, b) if a.tid < b.tid else (b, a)
                if ctx.ordered_before(lo.tid, hi.tid):
                    continue
                kind = "write-write" if (a_w and b_w) else "write-read"
                yield _diag("IO301",
                            f"{kind} race on path {path!r}: "
                            f"{lo.defn.signature}#{lo.tid} and "
                            f"{hi.defn.signature}#{hi.tid} touch it with "
                            f"no happens-before edge — pass a future "
                            f"between them or use distinct paths", hi)
                reported = True  # one report per path is enough signal
                break


def _rule_io302_read_after_discard(ctx: _Ctx) -> Iterator[Diagnostic]:
    if ctx.capture is None:
        return
    for dseq, ptid in ctx.capture.discards:
        for t in ctx.tasks:
            if getattr(t, "_plan_seq", 0) <= dseq:
                continue
            if ptid in ctx.future_inputs.get(t.tid, ()):
                yield _diag("IO302",
                            f"{t.defn.signature}#{t.tid} reads the output "
                            f"of task #{ptid} after rt.discard() promised "
                            f"it would never be read again — eviction may "
                            f"delete it without the durable drain; drop "
                            f"the discard or reorder the reader before "
                            f"it", t)
                break  # first offending reader per discard


def _rule_io303_payloadless_mover(ctx: _Ctx) -> Iterator[Diagnostic]:
    for t in ctx.io_tasks():
        if t.defn.signature not in _MOVER_SIGS:
            continue
        if t._datalife is not None:
            continue  # runtime-synthesized eviction/staging movers are
        #               ordered by the lifecycle machinery itself
        if t.sim.io_bytes <= 0 or ctx.future_inputs.get(t.tid):
            continue
        verb = "drains" if t.defn.signature == "tier_drain" else "prefetches"
        yield _diag("IO303",
                    f"{t.defn.signature}#{t.tid} {verb} "
                    f"{t.sim.io_bytes:g} MB with no dependency on a "
                    f"producer: the movement can race whatever writes the "
                    f"data it moves — pass the payload Future "
                    f"(rt.drain(fut, ...))", t)


def _commit_like(sig: str) -> bool:
    s = sig.lower()
    return "commit" in s or "manifest" in s


def _shard_like(sig: str) -> bool:
    return "shard" in sig.lower()


def _rule_io304_manifest_order(ctx: _Ctx) -> Iterator[Diagnostic]:
    """A commit/manifest task must be ordered after every shard task
    submitted since the previous commit (the checkpoint protocol: a
    manifest that lands before its shards are durable publishes a
    checkpoint a restart cannot read)."""
    window: list[TaskInstance] = []
    for t in ctx.tasks:
        sig = t.defn.signature
        if _commit_like(sig):
            for s in window:
                if not ctx.ordered_before(s.tid, t.tid):
                    yield _diag("IO304",
                                f"commit/manifest task runs with no "
                                f"ordering after shard task "
                                f"{s.defn.signature}#{s.tid}: the manifest "
                                f"could publish a checkpoint whose shards "
                                f"are not yet durable — pass the shard "
                                f"futures into the commit task", t)
                    break
            window = []
        elif _shard_like(sig):
            window.append(t)


# --------------------------------------------------------------------------
# IO4xx — determinism
# --------------------------------------------------------------------------
def _rule_io401_unseeded_bursts(ctx: _Ctx) -> Iterator[Diagnostic]:
    eng = ctx.rt.interference
    if eng is None:
        return
    seen = set()
    for b in getattr(eng, "_bindings", ()):
        m = b.model
        if not isinstance(m, BurstyTraffic) or getattr(m, "seeded", True):
            continue
        if id(m) in seen:
            continue
        seen.add(id(m))
        yield Diagnostic("IO401",
                         f"BurstyTraffic bound to device "
                         f"{b.device.name!r} has no seed: the burst train "
                         f"is drawn from OS entropy, so runs are not "
                         f"reproducible — pass seed=<int>")


_RNG_NAMES = frozenset({"random", "uuid1", "uuid4", "urandom",
                        "getrandbits", "token_bytes", "token_hex",
                        "SystemRandom"})


def _code_rng_use(code, depth: int = 0) -> Optional[str]:
    hit = _RNG_NAMES.intersection(code.co_names)
    if hit:
        return sorted(hit)[0]
    if depth < 3:
        for const in code.co_consts:
            if hasattr(const, "co_names"):
                inner = _code_rng_use(const, depth + 1)
                if inner is not None:
                    return inner
    return None


def _rule_io402_rng_in_body(ctx: _Ctx) -> Iterator[Diagnostic]:
    seen = set()
    for t in ctx.tasks:
        sig = t.defn.signature
        if sig in seen:
            continue
        seen.add(sig)
        code = getattr(t.defn.fn, "__code__", None)
        if code is None:
            continue
        name = _code_rng_use(code)
        if name is not None:
            yield _diag("IO402",
                        f"task body references unseeded RNG source "
                        f"{name!r}: its output differs run to run — seed "
                        f"a generator outside the task and pass it in as "
                        f"an argument", t)


# --------------------------------------------------------------------------
# IO5xx — failure domains
# --------------------------------------------------------------------------
def _rule_io501_durable_tier_killed(ctx: _Ctx) -> Iterator[Diagnostic]:
    """The failure schedule takes every device of the catalog's durable
    tier offline and never brings one back: eviction drains and emergency
    re-drains have nowhere durable to land, so recovery queues forever
    (the run ends in a SchedulerError, or quiesces with undurable data)."""
    eng = getattr(ctx.rt, "failures", None)
    if eng is None:
        return
    cat = ctx.catalog
    if cat is None or not cat.enabled or cat.durable_tier is None:
        return
    devs = [d for d in ctx.cluster.devices if d.tier == cat.durable_tier]
    if devs and all(eng.final_state(d) == "offline" for d in devs):
        names = [d.name for d in devs]
        yield Diagnostic(
            "IO501",
            f"the failure schedule leaves every device of the durable tier "
            f"{cat.durable_tier!r} offline with no recovery ({names}): "
            f"eviction drains and emergency re-drains have nowhere durable "
            f"to land — add a recovery event or pick another durable_tier")


# --------------------------------------------------------------------------
# IO6xx — sharding (core.shardplane, docs/scale.md)
# --------------------------------------------------------------------------
def _shared_tier_names(cluster) -> set:
    """Tiers backed by a device that two or more workers reference — the
    lease-brokered cross-shard resources (per-worker SSDs never qualify).
    Matches :func:`repro.core.shardplane.shared_devices` for any shard
    count >= 2, so the diagnostics are shard-count-agnostic."""
    refs: dict[int, int] = {}
    tier_of: dict[int, Optional[str]] = {}
    for w in cluster.workers:
        for dev in w.tiers:
            refs[id(dev)] = refs.get(id(dev), 0) + 1
            tier_of[id(dev)] = dev.tier
    return {tier_of[i] for i, n in refs.items() if n > 1}


def _rule_io601_shard_pingpong(ctx: _Ctx) -> Iterator[Diagnostic]:
    """A dependency chain whose ``shard_key=`` anchors alternate workers:
    under any shard count that separates those anchor workers, every edge
    of the chain is a cross-shard DEP_DONE message and the consumer's
    placement loses its producer's locality. Anchors are compared at the
    *worker* level (``key % n_workers``), which is what makes the finding
    independent of the shard count the plan eventually runs with."""
    from ..core.shardplane import anchor_worker  # lazy: keep lint importable
    n_workers = len(ctx.cluster.workers)
    if n_workers < 2:
        return
    by_tid = {t.tid: t for t in ctx.tasks}
    seen = set()
    for t in ctx.tasks:
        if t.shard_key is None:
            continue
        a = anchor_worker(t.shard_key, n_workers)
        for ptid in ctx.future_inputs.get(t.tid, ()):
            p = by_tid.get(ptid)
            if p is None or p.shard_key is None:
                continue
            pa = anchor_worker(p.shard_key, n_workers)
            if pa == a:
                continue
            key = (p.defn.signature, t.defn.signature)
            if key in seen:
                continue
            seen.add(key)
            yield _diag(
                "IO601",
                f"shard_key={t.shard_key!r} anchors this task to worker "
                f"{a} but its producer {p.defn.signature}#{p.tid} is "
                f"anchored to worker {pa} (shard_key={p.shard_key!r}): the "
                f"chain ping-pongs across shards — every edge becomes a "
                f"cross-shard message and placement loses producer "
                f"locality; use one shard_key along a dependency chain", t)


def _rule_io602_shared_tier_fanout(ctx: _Ctx) -> Iterator[Diagnostic]:
    """An I/O task pinned to a *shared* tier (burst buffer / shared FS)
    whose readers are anchored to two or more distinct workers: its output
    object's residency updates broadcast to every shard, and all reader
    shards contend for the one lease-brokered device. Often intended —
    shared tiers are the designed cross-shard channel — but worth flagging
    when a per-worker tier would do."""
    from ..core.shardplane import anchor_worker  # lazy: keep lint importable
    n_workers = len(ctx.cluster.workers)
    if n_workers < 2:
        return
    shared = _shared_tier_names(ctx.cluster)
    if not shared:
        return
    reader_anchors: dict[int, set] = {}   # producer tid -> anchor workers
    for t in ctx.tasks:
        if t.shard_key is None:
            continue
        a = anchor_worker(t.shard_key, n_workers)
        for ptid in ctx.future_inputs.get(t.tid, ()):
            reader_anchors.setdefault(ptid, set()).add(a)
    seen = set()
    for t in ctx.io_tasks():
        if t.tier not in shared:
            continue
        anchors = reader_anchors.get(t.tid, ())
        if len(anchors) < 2:
            continue
        sig = t.defn.signature
        if sig in seen:
            continue
        seen.add(sig)
        yield _diag(
            "IO602",
            f"output pinned to shared tier {t.tier!r} is read by tasks "
            f"anchored to {len(anchors)} distinct workers "
            f"({sorted(anchors)}): every reader shard contends for the "
            f"one lease-brokered device and the object's residency "
            f"updates broadcast to all shards — expected for a designed "
            f"cross-shard exchange, otherwise keep the chain on one "
            f"shard_key or a per-worker tier", t)


_RULES = (
    _rule_io101_static_bw, _rule_io102_unknown_tier, _rule_io103_cpu_units,
    _rule_io104_auto_min,
    _rule_io201_oversized_object, _rule_io202_unevictable_footprint,
    _rule_io203_pin_leak, _rule_io204_finite_durable,
    _rule_io301_path_races, _rule_io302_read_after_discard,
    _rule_io303_payloadless_mover, _rule_io304_manifest_order,
    _rule_io401_unseeded_bursts, _rule_io402_rng_in_body,
    _rule_io501_durable_tier_killed,
    _rule_io601_shard_pingpong, _rule_io602_shared_tier_fanout,
)


def lint_runtime(rt) -> list[Diagnostic]:
    """Run every rule over the runtime's recorded plan. Deterministic
    output: sorted by (code, tid)."""
    ctx = _Ctx(rt)
    out: list[Diagnostic] = []
    for rule in _RULES:
        out.extend(rule(ctx))
    out.sort(key=lambda d: (d.code, d.tid if d.tid is not None else -1))
    return out


def lint_script(path: str, argv=None) -> tuple[list[Diagnostic], list[str]]:
    """Execute ``path`` under forced capture and lint every IORuntime it
    constructs. Returns ``(diagnostics, notes)`` — notes are harness
    observations (script raised after capture, nothing captured, ...), not
    diagnostics. Task bodies never run; script-level code does."""
    import runpy
    import sys

    from . import capture as cap

    cap.clear_registry()
    cap.set_force(True)
    notes: list[str] = []
    old_argv = sys.argv
    sys.argv = [path] + list(argv or [])
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        if e.code not in (0, None):
            notes.append(f"{path}: exited with status {e.code}")
    except BaseException as e:  # noqa: BLE001 — scripts may do anything;
        #                         the captured plan is still worth linting
        notes.append(f"{path}: raised {type(e).__name__} after capture "
                     f"({e}) — values are None under capture; guard "
                     f"result post-processing")
    finally:
        sys.argv = old_argv
        cap.set_force(False)
    runtimes = cap.registered()
    cap.clear_registry()
    if not runtimes:
        notes.append(f"{path}: no IORuntime constructed — nothing captured")
    diags: list[Diagnostic] = []
    for rt in runtimes:
        diags.extend(lint_runtime(rt))
    return diags, notes
