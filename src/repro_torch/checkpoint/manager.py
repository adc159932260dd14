"""Checkpoint manager: async sharded saves routed through the I/O-aware
runtime (THE paper integration), atomic manifest commit, latest-valid
discovery for restart, elastic re-sharding restore. Mirror of
``repro.checkpoint.manager``; its checkpoints are the JAX package's
(``serializer``), and its I/O tasks come from the port's copy of the
runtime.

A tree of DTensors is saved as the reference's single controller saves a
global array: whole logical leaves. Every rank gathers each leaf, rank 0
writes the shards through its runtime, and the other ranks wait at a barrier
until the manifest is committed (at the end of ``save`` when it writes
inline, else in ``wait``). Every rank calls ``save`` and ``wait`` alike. A
sharded save waits for the one before it instead of skipping.

Each shard write is an I/O task (``@io`` + ``storageBW="auto"`` by default):
it overlaps with subsequent train steps, and the auto-tuner learns how many
shards may write concurrently before the storage device congests — exactly
the paper's checkpointFrag scenario (§5.2.1).

Burst-buffer mode (``fast_dir=``): shards are first written to a fast tier
(node-local SSD / burst buffer directory), then *drained* to the shared
``directory`` by runtime-generated drain I/O tasks that overlap with
subsequent compute; the manifest commits on the shared FS only after every
shard has landed there (manifest-last stays atomic), so a restart never
sees a checkpoint whose shards still live only in the volatile fast tier.
On a tiered cluster the drain tasks carry a ``storage_tier="fs"`` hint so
the simulator/scheduler charges them to the shared-FS device.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import warnings
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..convert import LayerStack
from ..core import constraint, current_runtime, io, task
from ..core.runtime import copy_fsync
from ..distributed.sharding import Sharding, place_tensor
from .serializer import (flatten_with_paths, plan_shards, read_shard, to_host,
                         unflatten_like, write_shard)


def _is_sharded(leaves) -> bool:
    return any(isinstance(t, DTensor)
               for _, v in leaves for t in (v if isinstance(v, LayerStack) else [v]))


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _place_like(tree, like, shardings):
    """``tree`` with each tensor placed by its ``shardings`` leaf (a
    ``Sharding``), or, without one, laid out as its ``like`` leaf when that
    is a DTensor."""
    if isinstance(tree, torch.Tensor):
        if shardings is None and isinstance(like, DTensor):
            shardings = Sharding(like.device_mesh, tuple(like.placements))
        return tree if shardings is None else place_tensor(tree, shardings)
    if isinstance(tree, dict):
        return {k: _place_like(v, like[k], None if shardings is None else shardings[k])
                for k, v in tree.items()}
    subs = [None] * len(tree) if shardings is None else shardings
    out = [_place_like(*args) for args in zip(tree, like, subs)]
    return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)


@constraint(storageBW="auto", maxRetries=2)
@io
@task(returns=1)
def _write_shard_task(path_str, entries):
    return write_shard(Path(path_str), entries)


@constraint(maxRetries=2)
@io
@task(returns=1)
def _drain_shard_task(frag, src_path, dst_path):
    """Copy one shard from the fast tier to the shared FS (fsync'd), passing
    the manifest fragment through so the commit can depend on the drain."""
    copy_fsync(src_path, dst_path)
    return frag


def _write_manifest_atomic(manifest_path, manifest: dict) -> None:
    """Crash-atomic manifest publish: write tmp, fsync it, rename over the
    final name, fsync the directory. Without the two fsyncs (copy_fsync's
    pattern) "manifest-last" is not crash-consistent on a real FS — the
    rename can be durable while the manifest bytes (or the directory entry)
    are still only in the page cache, publishing a checkpoint a restart
    cannot read."""
    manifest_path = Path(manifest_path)
    tmp = Path(str(manifest_path) + ".tmp")
    with open(tmp, "w") as f:
        f.write(json.dumps(manifest, indent=1))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, manifest_path)  # atomic: manifest-last commit
    dfd = os.open(str(manifest_path.parent), os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


@io
@task(returns=1)
def _commit_task(manifest_path, step, frags, t0):
    frags = [f for f in frags]
    manifest = {"step": step, "shards": frags, "version": 1,
                "save_seconds": time.monotonic() - t0}
    _write_manifest_atomic(manifest_path, manifest)
    return manifest


class CheckpointManager:
    """``directory`` is the durable (shared-FS) home of checkpoints.
    ``fast_dir`` enables burst-buffer mode: async saves write shards there
    first and drain them to ``directory`` in the background; ``drain_bw``
    optionally throttles each drain stream (static MB/s or "auto") so the
    write-back doesn't congest the shared FS.

    Capacity-aware GC: the fast tier is finite (it's a burst buffer), so it
    is trimmed more aggressively than the durable copy — ``fast_keep``
    bounds how many steps' shards stay there (default ``min(keep, 1)``:
    only the in-flight/most recent save, since every older step is already
    durable on ``directory`` and restart never reads the fast tier)."""

    def __init__(self, directory, n_shards: int = 8,
                 overrun_policy: str = "skip", keep: int = 3,
                 fast_dir=None, drain_bw=None, fast_keep=None,
                 fast_tier: str = "bb"):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.n_shards = n_shards
        self.overrun_policy = overrun_policy  # skip | wait
        self.keep = keep
        self.fast_dir = Path(fast_dir) if fast_dir is not None else None
        if self.fast_dir is not None:
            self.fast_dir.mkdir(parents=True, exist_ok=True)
        self.drain_bw = drain_bw
        if fast_keep is not None and fast_keep < 0:
            raise ValueError(f"fast_keep must be >= 0, got {fast_keep}")
        self.fast_keep = min(keep, 1) if fast_keep is None else int(fast_keep)
        self.fast_tier = fast_tier  # tier label backing fast_dir: when every
        #                             device of it is offline, saves reroute
        #                             shards to the shared FS directly
        self._in_flight = None  # (step, commit future)
        self._barrier_pending = False  # a sharded save not yet waited for

    def _fast_tier_offline(self, rt) -> bool:
        """True when the cluster models the fast tier and every device
        backing it is offline — writing the burst there would just fail
        into retries that can never land, so ``save`` reroutes."""
        if rt is None:
            return False
        devs = [d for d in rt.cluster.devices if d.tier == self.fast_tier]
        return bool(devs) and all(d.health == "offline" for d in devs)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, sync: bool = False) -> bool:
        """Async save via the ambient IORuntime; sync=True (or no runtime)
        writes inline. Returns False if skipped due to an in-flight save.
        Every leaf is copied to the host before ``save`` returns, so the
        caller may update its tensors in place at once."""
        rt = current_runtime()
        leaves = flatten_with_paths(tree)
        sharded = _is_sharded(leaves)
        if sharded:
            self.wait()                 # the previous sharded save, on every rank
            host_leaves = [(k, to_host(v)) for k, v in leaves]
            if _rank() != 0:
                self._barrier_pending = True
                if rt is None or sync:
                    self.wait()
                return True
        if self._in_flight is not None and rt is not None:
            prev_step, fut = self._in_flight
            if not fut.resolved():
                if self.overrun_policy == "skip" and not sync:
                    return False
                rt.wait_on(fut)
            self._in_flight = None

        if not sharded:
            host_leaves = [(k, to_host(v)) for k, v in leaves]
        step_dir = self.dir / f"step_{step:08d}"
        step_dir.mkdir(parents=True, exist_ok=True)
        plan = plan_shards(host_leaves, self.n_shards)
        t0 = time.monotonic()
        if rt is None or sync:
            mode = "sync"
            frags = [write_shard(step_dir / f"shard_{i:04d}.bin", entries)
                     for i, entries in enumerate(plan) if entries]
            manifest = {"step": step, "shards": frags, "version": 1,
                        "save_seconds": time.monotonic() - t0}
            _write_manifest_atomic(step_dir / "MANIFEST.json", manifest)
        elif self.fast_dir is None or self._fast_tier_offline(rt):
            # flat mode — also the failure-domain reroute: with the fast
            # tier dead, shards write straight to the durable directory
            # (fs-hinted so the scheduler charges the shared FS device)
            mode = "reroute" if self.fast_dir is not None else "flat"
            fs_hint = "fs" if self.fast_dir is not None \
                and rt.cluster.has_tier("fs") else None
            futs = [_write_shard_task(str(step_dir / f"shard_{i:04d}.bin"),
                                      entries,
                                      io_mb=sum(a.nbytes for _, a in entries)
                                      / 1e6, storage_tier=fs_hint)
                    for i, entries in enumerate(plan) if entries]
            commit = _commit_task(step_dir / "MANIFEST.json", step, futs, t0)
            self._in_flight = (step, commit)
        else:
            # burst-buffer mode: absorb the write burst on the fast tier,
            # drain to the shared FS asynchronously, commit manifest-last on
            # the shared FS once every shard has landed there
            mode = "burst-buffer"
            fast_step = self.fast_dir / f"step_{step:08d}"
            fast_step.mkdir(parents=True, exist_ok=True)
            fs_hint = "fs" if rt.cluster.has_tier("fs") else None
            drained = []
            for i, entries in enumerate(plan):
                if not entries:
                    continue
                name = f"shard_{i:04d}.bin"
                mb = sum(a.nbytes for _, a in entries) / 1e6
                wf = _write_shard_task(str(fast_step / name), entries,
                                       io_mb=mb)
                drained.append(_drain_shard_task(
                    wf, str(fast_step / name), str(step_dir / name),
                    io_mb=mb, storage_tier=fs_hint,
                    storage_bw=self.drain_bw))
            commit = _commit_task(step_dir / "MANIFEST.json", step,
                                  drained, t0)
            self._in_flight = (step, commit)
        rec = getattr(rt, "recorder", None)
        if rec is not None:
            rec.on_ckpt("save", step, mode,
                        sum(1 for entries in plan if entries))
        self._gc()
        if sharded:
            self._barrier_pending = True
            if mode == "sync":
                self.wait()
        return True

    def wait(self):
        rt = current_runtime()
        if self._in_flight is not None and rt is not None:
            step = self._in_flight[0]
            rt.wait_on(self._in_flight[1])
            self._in_flight = None
            rec = getattr(rt, "recorder", None)
            if rec is not None:
                rec.on_ckpt("wait", step, "async", 0)
            # the last save just became durable: one final fast-tier trim
            self._gc()
        if self._barrier_pending:       # every rank: rank 0's commit is durable
            self._barrier_pending = False
            dist.barrier()

    # --------------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for d in sorted(self.dir.glob("step_*")):
            if (d / "MANIFEST.json").exists():
                try:
                    json.loads((d / "MANIFEST.json").read_text())
                    out.append(int(d.name.split("_")[1]))
                except (json.JSONDecodeError, ValueError):
                    continue  # torn manifest -> checkpoint doesn't exist
        return out

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _check_step_durable(self, step: int) -> Optional[BaseException]:
        """Verify every shard the manifest names exists with the declared
        size; returns the violation (an IOError) or None when intact. A
        vanished shard (fast-tier loss after a partial drain) used to
        surface as a raw FileNotFoundError out of ``restore``."""
        step_dir = self.dir / f"step_{step:08d}"
        try:
            manifest = json.loads((step_dir / "MANIFEST.json").read_text())
        except (OSError, json.JSONDecodeError, ValueError) as e:
            return IOError(f"step {step}: unreadable manifest ({e})")
        for frag in manifest["shards"]:
            path = step_dir / frag["file"]
            if not path.exists():
                return IOError(
                    f"shard {path} missing (manifest names it with "
                    f"{frag['total_bytes']} bytes)")
            size = path.stat().st_size
            if size != frag["total_bytes"]:
                return IOError(f"shard {path} truncated: "
                               f"{size} != {frag['total_bytes']}")
        return None

    def restore(self, like_tree, step: Optional[int] = None, shardings=None):
        """Rebuild the tree: each leaf in the dtype and on the device of its
        counterpart in ``like_tree``; if ``shardings`` (a tree of
        ``Sharding``s laid out as ``like_tree``, e.g. from
        ``distributed.shard_params``) is given, each leaf is placed by its
        sharding on that (possibly different) mesh — elastic restart.
        Without it a leaf whose counterpart is a DTensor is laid out as that
        one. Every rank reads the whole checkpoint.

        Every candidate step is verified shard-complete before it is read;
        when the newest step is torn (a shard vanished or truncated — e.g.
        fast-tier loss after a partial drain) and no explicit ``step`` was
        requested, restore warns and falls back to the next-older durable
        step instead of crashing."""
        if step is not None:
            candidates = [step]
        else:
            candidates = list(reversed(self.steps()))
        if not candidates:
            raise FileNotFoundError(f"no valid checkpoint under {self.dir}")
        chosen = None
        err: Optional[BaseException] = None
        for i, s in enumerate(candidates):
            e = self._check_step_durable(s)
            if e is None:
                chosen = s
                if i > 0:
                    warnings.warn(
                        f"checkpoint step {candidates[0]} is torn ({err}); "
                        f"falling back to older durable step {s}",
                        RuntimeWarning, stacklevel=2)
                break
            if err is None:
                err = e
        if chosen is None:
            raise err  # newest (or requested) step torn, nothing older
        step = chosen
        step_dir = self.dir / f"step_{step:08d}"
        manifest = json.loads((step_dir / "MANIFEST.json").read_text())
        rt = current_runtime()
        rec = getattr(rt, "recorder", None)
        if rec is not None:
            rec.on_ckpt("restore", step, "durable",
                        len(manifest["shards"]))
        by_key: dict = {}
        for frag in manifest["shards"]:
            read_shard(step_dir / frag["file"], frag, by_key)
        tree = unflatten_like(like_tree, by_key)
        return _place_like(tree, like_tree, shardings), step

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
            if self.fast_dir is not None:
                shutil.rmtree(self.fast_dir / f"step_{s:08d}",
                              ignore_errors=True)
        if self.fast_dir is None:
            return
        # capacity-aware fast-tier GC: the burst buffer is finite, so it is
        # trimmed to fast_keep steps — but only steps already durable on the
        # shared directory (manifest committed), and never the in-flight
        # save whose shards may still be draining
        fast_steps = sorted(
            int(d.name.split("_")[1]) for d in self.fast_dir.glob("step_*"))
        durable = set(steps)
        in_flight = self._in_flight[0] if self._in_flight else None
        candidates = [s for s in fast_steps
                      if s in durable and s != in_flight]
        trim = candidates[:-self.fast_keep] if self.fast_keep else candidates
        # a superseded step that never became durable is a failed save (its
        # drains are dead; saves are serialized, so anything older than the
        # newest dispatched step is final) — its shards would otherwise leak
        # on the finite fast tier forever
        newest = in_flight if in_flight is not None else \
            (max(durable) if durable else None)
        if newest is not None:
            trim = trim + [s for s in fast_steps
                           if s not in durable and s < newest]
        for s in trim:
            shutil.rmtree(self.fast_dir / f"step_{s:08d}",
                          ignore_errors=True)
