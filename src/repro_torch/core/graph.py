"""Data-dependency detection (paper §4.1.2).

Futures passed as arguments create read-after-write dependencies on the
producing task. DataHandles passed to parameters declared INOUT/OUT get
COMPSs-style version bumps: a writer depends on the previous writer *and*
on every reader of the current version (serialising in-place updates).
"""
from __future__ import annotations

import inspect

from .task import (DataHandle, Direction, Future, TaskInstance, TaskState)


def _param_names(defn) -> list[str]:
    cache = getattr(defn, "_param_names", None)
    if cache is None:
        try:
            cache = list(inspect.signature(defn.fn).parameters)
        except (TypeError, ValueError):
            cache = []
        defn._param_names = cache
    return cache


def iter_futures(obj, _depth=0):
    """Futures in an argument, recursing through lists/tuples/dicts (a task
    may take e.g. a list of futures — the checkpoint commit barrier does)."""
    if isinstance(obj, Future):
        yield obj
    elif _depth < 4:
        if isinstance(obj, (list, tuple)):
            for v in obj:
                yield from iter_futures(v, _depth + 1)
        elif isinstance(obj, dict):
            for v in obj.values():
                yield from iter_futures(v, _depth + 1)


def bind_args(task: "TaskInstance") -> list:
    """(param_name, argument) pairs in binding order (positional then
    keyword) — the order dependency detection and DataHandle version
    bumps observe."""
    names = _param_names(task.defn)
    return list(zip(names, task.args)) + list(task.kwargs.items())


def compute_deps(task: "TaskInstance", pairs=None) -> dict:
    """Predecessor detection WITHOUT mutating any DataHandle bookkeeping:
    maps each predecessor TaskInstance to True for a *data* edge
    (read-after-write / write-after-write) or False for an *anti* edge
    (write-after-read ordering only). Data wins when both apply.

    :meth:`TaskGraph.add` applies the handle side effects afterwards via
    :func:`apply_handle_effects`; the static-analysis capture recorder
    (repro.analysis.capture) calls this directly to record the full
    happens-before relation — including edges to already-DONE producers,
    which ``add`` elides as satisfied.

    ``pairs`` optionally carries a precomputed :func:`bind_args` result so
    a caller running both passes binds the arguments once.
    """
    deps: dict = {}  # predecessor TaskInstance -> is_data
    for pname, arg in (bind_args(task) if pairs is None else pairs):
        if isinstance(arg, DataHandle):
            direction = task.defn.param_dirs.get(pname, Direction.IN)
            if direction == Direction.IN:
                if arg.last_writer is not None:
                    deps[arg.last_writer] = True
            else:  # INOUT / OUT: write-after-write + write-after-read
                if direction == Direction.INOUT and \
                        arg.last_writer is not None:
                    deps[arg.last_writer] = True
                for r in arg.readers_since_write:
                    if r is not task:
                        deps.setdefault(r, False)  # anti edge
        else:
            for fut in iter_futures(arg):
                deps[fut.task] = True
    deps.pop(task, None)  # a handle passed twice can't self-depend
    return deps


def apply_handle_effects(task: "TaskInstance", pairs=None) -> None:
    """Second pass of dependency detection: record this task against every
    DataHandle argument (reader lists, version bumps, last-writer) in the
    same binding order the one-pass implementation used. ``pairs`` as in
    :func:`compute_deps`."""
    for pname, arg in (bind_args(task) if pairs is None else pairs):
        if not isinstance(arg, DataHandle):
            continue
        direction = task.defn.param_dirs.get(pname, Direction.IN)
        if direction == Direction.IN:
            arg.readers_since_write.append(task)
        else:
            arg.version += 1
            arg.last_writer = task
            arg.readers_since_write = []


class TaskGraph:
    def __init__(self):
        self.tasks: dict[int, TaskInstance] = {}
        self.unfinished: int = 0
        self._missing_deps: dict[int, int] = {}  # tid -> #unfinished deps
        # sharded control plane (core.shardplane): when the runtime routes
        # tasks to shards it flips track_shards so every edge is classified
        # at add() time — cross-shard edges are the dependency messages the
        # ShardBus will carry (already-DONE producers included: the edge
        # crossed the boundary even if it never blocked anything)
        self.track_shards = False
        self.cross_shard_edges = 0
        self.local_edges = 0

    def add(self, task: TaskInstance) -> bool:
        """Register a task; returns True if it is immediately ready.

        Edges are tagged by kind: *data* edges (futures, read-after-write,
        write-after-write on INOUT) require the producer to SUCCEED; *anti*
        edges (write-after-read serialisation) only require the predecessor
        to be out of the way, so a FAILED/cancelled predecessor satisfies
        them instead of propagating the failure.
        """
        pairs = bind_args(task)  # bound once, shared by both passes
        deps = compute_deps(task, pairs)  # dep -> is_data (data wins)
        apply_handle_effects(task, pairs)
        if self.track_shards:
            shard = task.shard
            for d in deps:
                if d.shard == shard:
                    self.local_edges += 1
                else:
                    self.cross_shard_edges += 1

        task.deps = set()
        task.anti_deps = set()
        dead = None
        for d, is_data in deps.items():
            if d.state == TaskState.DONE:
                continue  # satisfied
            if d.state == TaskState.FAILED:
                if is_data:
                    dead = dead or d  # producer already crashed: doomed
                continue  # a failed anti-predecessor is out of the way
            task.deps.add(d.tid)
            if not is_data:
                task.anti_deps.add(d.tid)
            d.children.append(task.tid)
        self.tasks[task.tid] = task
        if dead is not None:
            task.state = TaskState.FAILED
            task.error = RuntimeError(
                f"cancelled: ancestor {dead.defn.name}#{dead.tid} failed")
            for f in task.futures:
                f.set_value(None)  # cancelled: resolve so waiters can't hang
            return False
        self.unfinished += 1
        if not task.deps:
            task.state = TaskState.READY
            return True
        self._missing_deps[task.tid] = len(task.deps)
        return False

    def complete(self, task: TaskInstance) -> list[TaskInstance]:
        """Mark done; return children that became ready.

        Children are stored as tids and appended at submission time, so the
        returned batch is deterministically in submission (tid) order — the
        scheduler relies on this for reproducible launch logs.
        """
        task.state = TaskState.DONE
        self.unfinished -= 1
        newly_ready = []
        missing = self._missing_deps
        for ctid in task.children:
            child = self.tasks[ctid]
            if child.state != TaskState.PENDING:
                continue
            missing[ctid] -= 1
            if missing[ctid] == 0:
                del missing[ctid]
                child.state = TaskState.READY
                newly_ready.append(child)
        return newly_ready

    def fail(self, task: TaskInstance
             ) -> tuple[list[TaskInstance], list[TaskInstance]]:
        """Remove a FAILED task from the graph and cancel its descendants.

        A PENDING task downstream of a failure can never have its missing
        *data* dependency satisfied; without transitive cancellation those
        tasks would keep ``unfinished`` positive forever and hang any drain
        loop waiting on it. *Anti* edges (write-after-read) are instead
        treated as satisfied — the failed predecessor will never touch the
        handle — so their successors may become READY. Returns
        ``(cancelled, newly_ready)``, each in submission order.
        """
        self.unfinished -= 1
        cancelled: list[TaskInstance] = []
        newly_ready: list[TaskInstance] = []
        missing = self._missing_deps
        stack = [task]
        while stack:
            failed = stack.pop()
            for ctid in failed.children:
                child = self.tasks.get(ctid)
                if child is None or child.state != TaskState.PENDING:
                    continue  # descendants of an unfinished failure that are
                #               not DONE/FAILED are necessarily PENDING
                if failed.tid in child.anti_deps:
                    # ordering-only edge: satisfied by the cancellation
                    missing[ctid] -= 1
                    if missing[ctid] == 0:
                        del missing[ctid]
                        child.state = TaskState.READY
                        newly_ready.append(child)
                    continue
                child.state = TaskState.FAILED
                if child.error is None:
                    child.error = RuntimeError(
                        f"cancelled: ancestor "
                        f"{failed.defn.name}#{failed.tid} failed")
                for f in child.futures:
                    f.set_value(None)  # resolve: wait_on a cancelled task's
                #                        future must return, not hang a drain
                missing.pop(ctid, None)
                self.unfinished -= 1
                cancelled.append(child)
                stack.append(child)
        cancelled.sort(key=lambda t: t.tid)
        newly_ready.sort(key=lambda t: t.tid)
        return cancelled, newly_ready
