"""Multi-pod dry-run of the port. Mirror of ``repro.launch.dryrun``.

For every (architecture x input-shape x mesh) combination the step of
``launch/specs.py::build_cell`` must run on the 16x16 single-pod mesh AND
the 2x16x16 two-pod mesh. The reference lowers and compiles it for 256 or
512 faked XLA host devices; the port runs it once as rank 0 of a faked
process group of 256 or 512 ranks (``torch.distributed``'s ``fake``
backend: every collective returns at once), every tensor on ``meta``, so
nothing is computed and nothing is allocated, while rank 0 does exactly
the work its shards ask for. A ``StepMeter`` watches that run on rank 0's
local tensors and records per cell:

- ``trace_s``: the run's wall time (the counterpart of ``lower_s`` and
  ``compile_s``);
- ``flops``: the floating-point operations of rank 0's shards
  (``torch.utils.flop_counter``'s formulas: matrix products and
  convolutions), per device as the reference's ``cost_analysis``;
- ``collectives``: the collectives rank 0 issues (DTensor's functional
  collectives, and the c10d calls of the MoE's ``shard_map``), their
  ``bytes_by_op``, ``count_by_op`` and ``total_bytes`` under the
  reference's traffic model (``parse_collectives``): bytes = result size
  x factor, all-reduce 2, reduce-scatter the group size, others 1. The
  port loops over layers in Python, so every call is seen and there is no
  loop trip count to infer. On a mesh of the CPU DTensor moves a
  shard-to-shard change as an all-gather (a CUDA mesh would use an
  all-to-all);
- ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes``, the
  bytes of rank 0's shards of the inputs and outputs (each storage once;
  ``argument_size_by_input`` splits the first by the step's arguments),
  ``alias_size_in_bytes``, the outputs' bytes that are inputs' storages
  (the train step updates the parameters and moments in place), and
  ``temp_size_in_bytes``, the peak of live storages during the step above
  the arguments, of which ``attention_scores_at_peak_in_bytes`` are the
  plain attention path's ``(..., Sq, S)`` score matrices, probabilities and
  masks (a kernel route holds none of them).

The reference's ``bytes_accessed``, ``cost_analysis``, ``hlo_bytes`` and
``generated_code_size_in_bytes`` come from XLA's compiled program and have
no counterpart here; they are left out.

The configs keep their kernel flags as ``get_config`` gives them (off): on
``meta`` a kernel route raises, and the plain path's intermediates (the
attention's score matrices) are in the memory this counts.

The faked group is process-wide, so the CLI owns its process, as the
reference's owns its XLA device count.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force]
"""
from __future__ import annotations

import argparse
import json
import logging
import math
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import ARCHS, SHAPES, cell_supported, get_config
from ..distributed import mesh_context
from ..distributed.sharding import OPT_RULES, STRATEGIES
from .mesh import make_production_mesh as _production_mesh

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# the plain attention path's query chunk (``models.attention.multihead_attn``)
CHUNK_Q = 1024
# the step's arguments, by the kind of its cell (``specs.build_cell``)
ARG_NAMES = {"train": ("params", "opt_state", "batch"), "prefill": ("params", "batch"),
             "decode": ("params", "state", "tokens")}
# the reference's names for the collectives, by the op's name without "_"
_KINDS = (("allgather", "all-gather"), ("reducescatter", "reduce-scatter"),
          ("allreduce", "all-reduce"), ("alltoall", "all-to-all"), ("broadcast", "broadcast"))
_NOT_TRAFFIC = ("wait", "barrier", "work", "wraptensor")


def _fake_group(world: int) -> None:
    """A faked process group of ``world`` ranks, this process rank 0 (a
    faked group of another size is replaced)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized() and dist.get_world_size() != world:
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry-run needs a faked process group; a real one is running")
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    # DTensor notes each reduction over two mesh axes as two collectives
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)


def fake_mesh(shape, names):
    """A ``DeviceMesh`` of the given shape on the CPU over a faked group of
    that many ranks; its tensors may lie on ``meta``."""
    from torch.distributed.device_mesh import init_device_mesh
    _fake_group(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """``launch.mesh.make_production_mesh`` on the CPU over a faked group of
    256 or 512 ranks."""
    _fake_group(512 if multi_pod else 256)
    return _production_mesh(multi_pod=multi_pod, device="cpu")


def _collective(func):
    """The reference's name of a collective op's kind, or None."""
    if func.namespace not in ("_c10d_functional", "c10d"):
        return None
    name = func._opname.replace("_", "")
    if any(name.startswith(w) for w in _NOT_TRAFFIC):
        return None
    for key, kind in _KINDS:
        if key in name:
            return kind
    return func._opname


def _group_size(args) -> int:
    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    ints = [a for a in args if isinstance(a, int) and not isinstance(a, bool)]
    return ints[0] if ints else 1


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _tensors(tree) -> list:
    """The tensors of a tree of tuples, dicts and modules (a module's
    parameters)."""
    out = []
    for leaf in tree_leaves(tree, is_leaf=lambda x: isinstance(x, torch.nn.Module)):
        if isinstance(leaf, torch.nn.Module):
            out += list(leaf.parameters())
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _storages(tree) -> dict:
    """``{storage key: bytes}`` of the local tensors of a tree, each storage
    once."""
    out = {}
    for t in _tensors(tree):
        st = _local(t).untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


class StepMeter(TorchDispatchMode):
    """Counts what this rank's local tensors do: flops, collective traffic
    and the live bytes of storages, with their peak; with ``tag`` (a
    predicate on a storage's first tensor) also the live bytes of the tagged
    storages at that peak. An op on DTensors is
    let through (``NotImplemented``), so that DTensor runs it as local ops
    and the meter sees those, with their local shapes; a mode that counted
    the DTensor op itself (``FlopCounterMode`` entered outside DTensor)
    would count the global shapes. The ops DTensor runs under its own fake
    mode to propagate shardings (on global shapes) are not counted."""

    def __init__(self, tag=None):
        super().__init__()
        self.flops = 0
        self.bytes_by_op: dict[str, float] = {}
        self.count_by_op: dict[str, int] = {}
        self.live = self.peak = 0
        self.tag = tag
        self.live_tagged = self.tagged_at_peak = 0
        self._seen: set = set()

    def track(self, t) -> None:
        t = _local(t)
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        tagged = n if self.tag is not None and self.tag(t) else 0
        self._seen.add(key)
        self.live += n
        self.live_tagged += tagged
        if self.live > self.peak:
            self.peak, self.tagged_at_peak = self.live, self.live_tagged
        weakref.finalize(st, self._free, key, n, tagged)

    def _free(self, key, n, tagged) -> None:
        self._seen.discard(key)
        self.live -= n
        self.live_tagged -= tagged

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if active_fake_mode() is not None:
            # DTensor's sharding propagation, on global shapes
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        kind = _collective(func)
        if kind is not None:
            # the result: the op's output, or a c10d op's in-place tensors
            result = out if func.namespace == "_c10d_functional" else args[0]
            factor = {"all-reduce": 2.0, "reduce-scatter": float(max(_group_size(args), 1))}
            self.bytes_by_op[kind] = (self.bytes_by_op.get(kind, 0.0)
                                      + _nbytes(result) * factor.get(kind, 1.0))
            self.count_by_op[kind] = self.count_by_op.get(kind, 0) + 1
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.track(t)
        return out


def _dense_attention(t, seq_len: int) -> bool:
    """Is ``t`` shaped like the plain attention path's score matrices,
    probabilities and masks, ``(..., Sq, S)`` with ``Sq`` the sequence or a
    query chunk (``models.attention``)? A kernel route holds none of them."""
    return t.dim() >= 3 and t.shape[-1] == seq_len and t.shape[-2] in (seq_len, CHUNK_Q)


def trace_cell(cfg, cell, mesh, strategy: str = "tp_fsdp") -> dict:
    """Build ``cell``'s step on ``meta`` and run it once under a
    ``StepMeter``; returns the record's measured part."""
    from .specs import build_cell
    with mesh_context(mesh, rules=STRATEGIES[strategy]):
        fn, args, _ = build_cell(cfg, cell, mesh, opt_rules=OPT_RULES.get(strategy))
        arg_storages = _storages(args)
        meter = StepMeter(tag=lambda t: _dense_attention(t, cell.seq_len))
        with meter:
            for t in _tensors(args):
                meter.track(t)
            base = meter.live
            meter.peak = base
            t0 = time.time()
            out = fn(*args)
            trace_s = time.time() - t0
        out_storages = _storages(out)
        return {
            "trace_s": round(trace_s, 1),
            "n_devices": int(mesh.mesh.numel()),
            "flops": float(meter.flops),
            "collectives": {"bytes_by_op": meter.bytes_by_op,
                            "count_by_op": meter.count_by_op,
                            "total_bytes": sum(meter.bytes_by_op.values())},
            "memory": {"argument_size_in_bytes": sum(arg_storages.values()),
                       "argument_size_by_input": {
                           name: sum(_storages(a).values())
                           for name, a in zip(ARG_NAMES[cell.kind], args)},
                       "output_size_in_bytes": sum(out_storages.values()),
                       "temp_size_in_bytes": meter.peak - base,
                       "attention_scores_at_peak_in_bytes": meter.tagged_at_peak,
                       "alias_size_in_bytes": sum(n for k, n in out_storages.items()
                                                  if k in arg_storages)},
        }


def run_cell(arch: str, shape: str, mesh_kind: str, force: bool = False,
             tag: str = "", cfg_override=None, strategy: str = "tp_fsdp") -> dict:
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    name = f"{arch}__{shape}__{mesh_kind}{tag}"
    path = ARTIFACTS / f"{name}.json"
    if path.exists() and not force:
        cached = json.loads(path.read_text())
        if cached.get("status") != "error":
            return cached  # errors are retried (they are bugs being fixed)

    cfg = cfg_override or get_config(arch)
    cell = SHAPES[shape]
    ok, reason = cell_supported(cfg, cell)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind, "tag": tag,
           "params": cfg.param_count(), "active_params": cfg.active_param_count()}
    if not ok:
        rec.update(status="skipped", reason=reason)
        path.write_text(json.dumps(rec, indent=1))
        return rec

    rec["strategy"] = strategy
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    try:
        model_axis = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))["model"]
        if cell.kind == "decode" and cell.global_batch % (mesh.mesh.numel() // model_axis):
            cfg = cfg.replace(decode_batch_replicated=True)
        rec.update(status="ok", **trace_cell(cfg, cell, mesh, strategy))
    except Exception as e:  # record failures: they are bugs to fix
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--strategy", default="tp_fsdp")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.list:
        for a in archs:
            for s in shapes:
                ok, why = cell_supported(get_config(a), SHAPES[s])
                print(f"{a:24} {s:12} {'RUN' if ok else 'SKIP: ' + why}")
        return 0

    failures = 0
    for a in archs:
        for s in shapes:
            for m in meshes:
                rec = run_cell(a, s, m, force=args.force,
                               strategy=args.strategy, tag=args.tag)
                line = f"{a:24} {s:12} {m:6} {rec['status']:8}"
                if rec["status"] == "ok":
                    line += (f" trace={rec['trace_s']:7.1f}s "
                             f"flops={rec['flops']:.3e} "
                             f"coll={rec['collectives']['total_bytes']:.3e}B")
                elif rec["status"] == "error":
                    line += " " + rec["error"][:120]
                    failures += 1
                else:
                    line += " " + rec.get("reason", "")
                print(line, flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
