"""Divisibility-aware logical-axis sharding on DTensor. Mirror of
``repro.distributed.sharding``.

Params/activations are annotated with *logical axis name* tuples; rules map
logical names to mesh axes. A rule is applied only when the dimension size is
divisible by the product of the mesh-axis sizes — otherwise the dim stays
replicated (this is what lets e.g. smollm's 15 heads lower cleanly on a
16-way "model" axis: its attention weights simply replicate).

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``. A spec (the reference's ``PartitionSpec``) is a tuple
with one entry per tensor dimension: ``None``, a mesh-axis name, or a tuple
of them. DTensor takes one placement per *mesh* dimension instead, so
``placements_for`` turns a spec into ``Shard``/``Replicate`` placements, and
a ``Sharding`` (the reference's ``NamedSharding``) is a mesh with them.
``spec_for`` and ``divisible_prefix`` read only the mesh's ``{name: size}``
and take a plain mapping as well.

Under ``mesh_context`` plain tensors meeting DTensors are taken as
replicated (``implicit_replication``), as an unannotated array is under the
reference's ``jit``: positions, masks and the step's inputs need no
annotation.
"""
from __future__ import annotations

import contextlib
import threading
from collections.abc import Mapping
from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication, local_map

# logical axis -> mesh axis (or tuple of mesh axes). None -> replicate.
LOGICAL_RULES: dict[str, object] = {
    "embed": "data",        # FSDP: weights stored sharded over data;
    #                         SPMD all-gathers one layer at a time inside scan
    "mlp": "model",         # TP
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    "experts": None,        # expert count (8/60) rarely divisible; TP via mlp
    "layers": None,
    "head_dim": None,
    "norm": None,
    "state": None,
    "conv": None,
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,
}


# Named sharding strategies, the reference's, value for value.
# "tp_fsdp": TP over "model" + FSDP weight storage over "data" (default).
# "fsdp":    no tensor parallelism — batch shards over every mesh axis and
#            weights are fully sharded for storage (ZeRO-3).
# "dp_fsdp": no TP; weights FSDP over "data" only, batch over every axis,
#            optimizer state sharded 2-D separately (OPT_RULES).
# "tp_serve": weight-stationary serving — pure TP over "model", no FSDP.
# "dp_tp_moe": dense parts pure-DP/FSDP like dp_fsdp, expert FFNs keep TP
#            over "model"; batch over (pod, data) only.
STRATEGIES: dict[str, dict] = {
    "tp_fsdp": dict(LOGICAL_RULES),
    "fsdp": {**LOGICAL_RULES,
             "embed": ("data", "model"),
             "mlp": None, "heads": None, "kv_heads": None, "vocab": None,
             "batch": ("pod", "data", "model")},
    "dp_fsdp": {**LOGICAL_RULES,
                "embed": ("data",),
                "mlp": None, "heads": None, "kv_heads": None, "vocab": None,
                "batch": ("pod", "data", "model")},
    "tp_serve": {**LOGICAL_RULES, "embed": None},
    "dp_tp_moe": {**LOGICAL_RULES,
                  "embed": ("data",), "heads": None, "kv_heads": None,
                  "vocab": None, "mlp": "model",
                  "batch": ("pod", "data")},
}

# optimizer-state rules per strategy (None -> same sharding as params)
OPT_RULES: dict[str, dict | None] = {
    "tp_fsdp": None,
    "fsdp": None,
    "dp_fsdp": {**LOGICAL_RULES,
                "embed": ("data", "model"), "mlp": ("model",),
                "heads": None, "kv_heads": None, "vocab": None},
}


class MeshContext(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict = dict(LOGICAL_RULES)


_ctx = MeshContext()


def current_mesh():
    return _ctx.mesh


def current_rules() -> dict:
    return _ctx.rules


@contextlib.contextmanager
def mesh_context(mesh, rules: dict | None = None):
    prev_mesh, prev_rules = _ctx.mesh, _ctx.rules
    _ctx.mesh = mesh
    _ctx.rules = {**LOGICAL_RULES, **(rules or {})}
    try:
        with implicit_replication():
            yield mesh
    finally:
        _ctx.mesh, _ctx.rules = prev_mesh, prev_rules


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, in mesh-dimension order; a
    mapping is taken as it is."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if not mesh.mesh_dim_names:
        raise ValueError("the mesh needs mesh_dim_names")
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axis_size(shape: dict, mesh_axes) -> int:
    if mesh_axes is None:
        return 1
    if isinstance(mesh_axes, str):
        mesh_axes = (mesh_axes,)
    n = 1
    for a in mesh_axes:
        n *= shape[a]
    return n


def divisible_prefix(dim: int, axes, mesh, used=()) -> tuple:
    """Longest prefix of ``axes`` present in the mesh, unused, and whose
    size product divides ``dim`` (graceful degradation: batch=256 on a
    512-chip mesh shards over (pod, data) and replicates over model)."""
    shape = mesh_shape(mesh)
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    axes = tuple(a for a in axes if a in shape and a not in used)
    while axes and dim % _axis_size(shape, axes) != 0:
        axes = axes[:-1]
    return axes


def spec_for(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
             mesh, rules: dict | None = None) -> tuple:
    """The spec of an array with the given logical axes, degrading any rule
    whose mesh-axis product does not divide the dimension to its longest
    divisible prefix, and never using a mesh axis twice. Trailing ``None``s
    are dropped, as ``PartitionSpec`` shows them."""
    rules = rules or current_rules()
    parts, used = [], set()
    for dim, name in zip(shape, logical_axes):
        mesh_axes = rules.get(name) if name else None
        tup = divisible_prefix(dim, mesh_axes, mesh, used)
        if not tup:
            parts.append(None)
            continue
        used.update(tup)
        parts.append(tup[0] if len(tup) == 1 else tup)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements_for(spec: Sequence, mesh) -> tuple[Placement, ...]:
    """DTensor placements (one per mesh dimension) of a spec (one entry per
    tensor dimension). A tensor dimension split over a tuple of mesh axes
    is ``Shard(d)`` on each of them; DTensor splits in mesh-dimension order,
    so the tuple must be in that order (every tuple of the rules is)."""
    names = list(mesh_shape(mesh))
    out: list[Placement] = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {part} is not in mesh order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


class Sharding(NamedTuple):
    """A mesh and one placement per mesh dimension: the reference's
    ``NamedSharding``."""
    mesh: object
    placements: tuple


def logical_to_sharding(shape, logical_axes, mesh=None, rules=None) -> Sharding:
    mesh = mesh or current_mesh()
    return Sharding(mesh, placements_for(spec_for(shape, logical_axes, mesh, rules), mesh))


def _per_tensor_axes(t, axes) -> tuple:
    """A per-layer tensor's axes: its stacked leaf's axes without the
    leading ``"layers"`` (which every rule leaves replicated)."""
    axes = tuple(axes)
    if len(axes) == t.dim() + 1 and axes[0] == "layers":
        return axes[1:]
    return axes


def shard_params(params, axes_tree: dict, mesh=None, rules=None) -> dict:
    """``{parameter name: Sharding}`` for a model and its logical-axes tree
    (``Model.logical_axes``)."""
    mesh = mesh or current_mesh()
    return {k: logical_to_sharding(t.shape, _per_tensor_axes(t, axes_tree[k]), mesh, rules)
            for k, t in params.named_parameters()}


def place_tensor(t: torch.Tensor, sharding: Sharding) -> DTensor:
    """``t`` (the same whole tensor on every rank) as a DTensor laid out by
    ``sharding``; a DTensor is redistributed onto it (another mesh goes
    through the whole tensor)."""
    if isinstance(t, DTensor):
        if t.device_mesh == sharding.mesh:
            return t.redistribute(sharding.mesh, sharding.placements)
        t = t.full_tensor()
    return distribute_tensor(t.detach(), sharding.mesh, list(sharding.placements),
                             src_data_rank=None)


@torch.no_grad()
def place(params: nn.Module, shardings: dict) -> nn.Module:
    """The counterpart of ``jax.tree.map(jax.device_put, params, sh)``: the
    model's parameters are replaced by DTensor parameters laid out by
    ``shardings`` (``shard_params``); returns the model."""
    for name, p in list(params.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        mod = params.get_submodule(mod_name)
        mod._parameters[attr] = nn.Parameter(place_tensor(p, shardings[name]),
                                             requires_grad=p.requires_grad)
    return params


def map_state(fn, tree, axes_tree):
    """``fn(tensor, its logical axes)`` over a decode state: a tree of
    NamedTuples whose leaves are tensors, and ``axes_tree`` its twin of
    axes tuples. A leaf that is not a tensor (``pos``) is kept as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, axes_tree)
    if isinstance(tree, tuple):
        return type(tree)(*(map_state(fn, t, a) for t, a in zip(tree, axes_tree)))
    return tree


def place_state(tree, axes_tree, mesh=None, rules=None):
    """A decode state laid out by its logical axes under the current mesh
    (the reference's ``device_put`` onto ``tree_shardings`` of
    ``decode_state_axes``); without a mesh, as it is."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return tree
    return map_state(lambda t, ax: place_tensor(t, logical_to_sharding(t.shape, ax, mesh, rules)),
                     tree, axes_tree)


def spec_of(x) -> tuple:
    """The spec (one entry per tensor dimension) of a DTensor's placements:
    the inverse of ``placements_for``. A plain tensor's is all ``None``."""
    parts: list = [None] * x.dim()
    if isinstance(x, DTensor):
        for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
            if isinstance(p, Shard):
                parts[p.dim] = entry_axes(parts[p.dim]) + (name,)
    return tuple(spec_entry(entry_axes(e)) for e in parts)


@torch.no_grad()
def assign(dst, index: tuple, src):
    """``dst[index] = src`` in place. On a DTensor ``dst`` each rank writes its
    own shard: ``index`` holds integers, slices and index tensors, and may
    only pick along dimensions that ``dst`` keeps whole (a sharded one takes
    ``slice(None)``); ``src`` is laid out like ``dst[index]`` first.
    (DTensor's rule for an indexed write, ``index_put_``, fails in torch
    2.11.)"""
    if not isinstance(dst, DTensor):
        dst[index] = src
        return
    mesh = dst.device_mesh
    index = tuple(index) + (slice(None),) * (dst.dim() - len(index))
    # where each kept dimension of dst lands in dst[index]
    kept = {d: n for n, d in enumerate(d for d, i in enumerate(index) if not isinstance(i, int))}
    placements = []
    for p in dst.placements:
        if isinstance(p, Shard):
            if not (isinstance(index[p.dim], slice) and index[p.dim] == slice(None)):
                raise ValueError(f"assign: dimension {p.dim} is sharded, index {index}")
            placements.append(Shard(kept[p.dim]))
        else:
            placements.append(Replicate())
    if not isinstance(src, DTensor):
        src = DTensor.from_local(torch.as_tensor(src, dtype=dst.dtype, device=dst.device),
                                 mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(src.placements) != tuple(placements):
        src = src.redistribute(mesh, placements)
    dst.to_local()[index] = src.to_local()


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (every rank must call it); a plain
    tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def shard_activation(x, logical_axes=None):
    """The reference's ``with_sharding_constraint`` for activations: batch
    dim over the batch rule, everything else replicated. No-op without a
    mesh context. Under one, a DTensor is redistributed and a plain tensor
    (the same on every rank: the step's inputs) becomes a DTensor, both
    differentiably."""
    mesh = current_mesh()
    if mesh is None:
        return x
    names = logical_axes or ("batch",) + (None,) * (x.dim() - 1)
    placements = placements_for(spec_for(x.shape, names, mesh), mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def batch_axes(mesh=None, dim: int | None = None) -> tuple:
    """Mesh axes a global batch dimension shards over (strategy-aware; with
    ``dim`` given, degrades to the longest divisible prefix)."""
    mesh = mesh or current_mesh()
    ax = current_rules().get("batch") or ()
    if dim is None:
        ax = (ax,) if isinstance(ax, str) else tuple(ax)
        shape = mesh_shape(mesh)
        return tuple(a for a in ax if a in shape)
    return divisible_prefix(dim, ax, mesh)


# --------------------------------------------------------------------------
# Running a per-shard function (a kernel launched on data pointers) on
# DTensors: the reference's shard_map / custom call, on local_map
# --------------------------------------------------------------------------
def partial_over(placements, dims) -> tuple:
    """``placements`` with ``Partial()`` on the mesh dimensions ``dims``."""
    return tuple(Partial() if i in dims else p for i, p in enumerate(placements))


def unshard_dim(x, dim: int):
    """``x`` with tensor dimension ``dim`` whole on every rank (its other
    placements kept): the explicit redistribute in front of an op whose
    DTensor rule fails on a sharded ``dim``. A plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.dim()
    placements = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim else p
                       for p in x.placements)
    if placements == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def fsdp_gather(w):
    """A weight stored sharded over the mesh axes the batch splits over
    (FSDP), all-gathered over them for its product, its tensor-parallel
    split kept: what the reference's SPMD program does one layer at a time.
    (Left to itself, DTensor splits the product's contraction over those
    axes instead, and each rank multiplies every token of the batch.) Its
    gradient comes back reduce-scattered. A plain tensor as it is."""
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    bax = set(batch_axes(mesh))
    placements = tuple(Replicate() if name in bax else p
                       for name, p in zip(mesh.mesh_dim_names, w.placements))
    if placements == tuple(w.placements):
        return w
    return w.redistribute(mesh, placements)


def _contract(x, w, n: int):
    """x (..., K1..Kn) @ w (K1..Kn, ...) -> (..., w.shape[n:])."""
    if n == 1 and w.dim() == 2:
        return x @ w            # w may be a transposed view: no copy of it
    lead = x.shape[:x.dim() - n]
    y = x.reshape(*lead, -1) @ w.reshape(w.shape[:n].numel(), -1)
    return y.reshape(*lead, *w.shape[n:])


def linear(x, w, n: int = 1):
    """The product of ``x``'s last ``n`` dimensions with ``w``'s first ``n``:
    ``(..., K1..Kn) x (K1..Kn, ...) -> (..., w.shape[n:])`` (``n = 1`` is
    ``x @ w``). Under a mesh it runs on each rank's shards: the weight
    gathered over the batch's axes (``fsdp_gather``), its tensor-parallel
    split kept; ``x`` split over the batch on its first dimension and like
    ``w`` on the contracted ones. The output is split like ``w``'s other
    dimensions, and a partial sum where ``w``'s contracted ones are split
    (row parallel). (DTensor's own rule for a matrix product picks among
    every layout of a 2- or 3-D mesh, minutes of planning on the 2x16x16
    one.)"""
    if not isinstance(w, DTensor) and not isinstance(x, DTensor):
        return _contract(x, w, n)
    w = fsdp_gather(w)
    mesh = w.device_mesh
    ws = spec_of(w)
    bax = batch_axes(mesh, x.shape[0])
    lead = (spec_entry(bax),) + (None,) * (x.dim() - n - 1)
    contracted = tuple(a for e in ws[:n] for a in entry_axes(e))
    kept = tuple(a for e in ws[n:] for a in entry_axes(e))
    fn = shard_map(lambda x, w: _contract(x, w, n), mesh, (lead + ws[:n], ws),
                   lead + ws[n:], partial_grads=[kept, bax], out_partial=contracted)
    return fn(x, w)


def _gather_last(x, index):
    return torch.gather(x, -1, index[..., None])[..., 0]


def local_gather_last(x, index):
    """``torch.gather(x, -1, index[..., None])[..., 0]``. On a DTensor it runs
    on each rank's batch, the last dimension whole: DTensor's own rule for
    ``gather`` goes through a mask placement that it shares with the
    embedding's, and fails."""
    if not isinstance(x, DTensor):
        return _gather_last(x, index)
    spec = spec_for(x.shape, ("batch",) + (None,) * (x.dim() - 1), x.device_mesh)
    return shard_map(_gather_last, x.device_mesh, (spec, spec), spec)(x, index)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous. ``local_map``
    wraps a local gradient into a DTensor that takes it as laid out like
    the contiguous whole; a transposed one (a matrix product's) then fails
    the next ``view`` of the gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _on_contiguous_grads(fn):
    def local(*args):
        return fn(*(_ContiguousGrad.apply(a) if isinstance(a, torch.Tensor) else a
                    for a in args))
    return local


def shard_map(fn, mesh, in_specs, out_specs, partial_grads=None, out_partial=()):
    """The reference's ``shard_map`` on ``local_map``: ``fn`` runs on each
    rank's shards of its tensor arguments, laid out by ``in_specs`` (each
    DTensor is redistributed onto its spec), and its outputs are put
    together as DTensors by ``out_specs`` (``fn`` returns one tensor, or a
    tuple when ``out_specs`` is a list). A plain tensor argument, the same
    on every rank, is taken as replicated first: ``local_map`` would hand
    it to ``fn`` whole.

    ``partial_grads[i]`` names the mesh axes over which input ``i`` is
    replicated but each rank's gradient is only its part of the whole (the
    rank saw other tokens, or other heads): ``Partial`` in
    ``in_grad_placements``, so the parts are added. Over any other axis the
    ranks compute the same gradient. ``out_partial`` names the mesh axes
    over which the (one) output is each rank's part of a sum. Differentiable."""
    names = list(mesh_shape(mesh))
    in_pl = tuple(placements_for(spec, mesh) for spec in in_specs)
    grad_pl = tuple(partial_over(pl, {names.index(n) for n in pg})
                    for pl, pg in zip(in_pl, partial_grads or [()] * len(in_specs)))
    many = isinstance(out_specs, list)
    # one output's placements as a list: local_map reads a tuple as one
    # placement list per output
    out_pl = (tuple(placements_for(spec, mesh) for spec in out_specs) if many
              else list(partial_over(placements_for(out_specs, mesh),
                                     {names.index(n) for n in out_partial})))
    mapped = local_map(_on_contiguous_grads(fn), out_placements=out_pl, in_placements=in_pl,
                       in_grad_placements=grad_pl, device_mesh=mesh, redistribute_inputs=True)
    replicated = [Replicate()] * len(names)

    def wrapped(*args):
        return mapped(*(DTensor.from_local(a, mesh, replicated, run_check=False)
                        if isinstance(a, torch.Tensor) and not isinstance(a, DTensor) else a
                        for a in args))
    return wrapped


def spec_entry(axes: tuple):
    """A spec entry for a tuple of mesh axes: None, one name, or the tuple."""
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry, as a tuple."""
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def attention_specs(q_shape, kv_shape, mesh) -> tuple[tuple, tuple]:
    """Specs of ``q (B,S,H,hd)`` and ``k``/``v (B,S,KV,hd)`` for attention on
    each rank's shard: the batch over the batch rule, and the heads over the
    heads rule. Where ``KV`` does not split as ``H`` does (the ``model``
    axis exceeds the KV heads), the query heads still split if each rank's
    block of them lies within one GQA group or covers whole groups; K and V
    are whole then, and each rank reads the KV heads of its query heads
    (``kv_heads_of_rank``). Otherwise the heads are whole."""
    sq = tuple(spec_for(q_shape, ("batch", None, "heads", None), mesh)) + (None,) * 4
    sk = tuple(spec_for(kv_shape, ("batch", None, "kv_heads", None), mesh)) + (None,) * 4
    qh, kh = sq[2], sk[2]
    if qh != kh:
        n = q_shape[2] // _axis_size(mesh_shape(mesh), qh)      # query heads a rank
        G = q_shape[2] // kv_shape[2]
        if qh is None or kh is not None or (G % n and n % G):
            qh = kh = None
    return (sq[0], None, qh, None), (sk[0], None, kh, None)


def kv_heads_of_rank(q_entry, kv_entry, H: int, KV: int, mesh) -> slice:
    """The KV heads that this rank's query heads read where the query heads
    split over mesh axes (``q_entry``) and the KV heads are whole
    (``attention_specs``); all of them (``slice(None)``) where the two split
    alike."""
    if q_entry == kv_entry:
        return slice(None)
    names = list(mesh.mesh_dim_names)
    coord, parts = 0, 1
    for a in entry_axes(q_entry):
        coord = coord * mesh.size(names.index(a)) + mesh.get_local_rank(a)
        parts *= mesh.size(names.index(a))
    n, G = H // parts, H // KV
    return slice(coord * n // G, coord * n // G + max(1, n // G))


def unshard_unless_divides(x, dim: int, n: int):
    """``x``, about to have dimension ``dim`` split into ``(n, rest)``, with
    that dimension gathered whole unless the mesh axes it is sharded over
    divide ``n`` (DTensor cannot split an unevenly sharded dimension). A
    plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.dim()
    parts = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            parts *= x.device_mesh.size(i)
    return x if n % parts == 0 else unshard_dim(x, dim)
