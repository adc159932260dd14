"""Mixture-of-Experts FFN (mixtral-style top-k routed + qwen-style shared
experts) with sort-based token dispatch and capacity dropping. Mirror of
``repro.models.moe``; beside it a dropless dispatch (``dropless_ffn``,
port-only) for the models published without a capacity.

Dispatch runs *locally per data shard* under a mesh with a ``model`` axis
(``distributed.sharding.shard_map``, the reference's ``shard_map`` on
``local_map``), so the token sort never becomes a global collective: each
data shard routes its own tokens at a capacity from its own token count,
and the only collective is the tensor-parallel sum of the down-projection
over ``model``, taken after the scatter-back. The aux loss returned is data
shard 0's, as the reference's unchecked ``out_specs=P()`` keeps one shard's
value. When no such mesh is active the same function runs unpartitioned.

The expert products are batched matrix products over the experts
(``torch.bmm``), as the reference leaves them to XLA's ``einsum``: the
reference has no kernel for MoE. On the card nothing here synchronises the
host: counts are built with ``index_add_``, the dropped assignments are
chosen with ``where`` and the capacity comes from Python ints, so a decode
step that calls the dispatch once a layer never waits for the device.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import (batch_axes, current_mesh, current_rules, mesh_shape,
                                    shard_map, spec_entry)
from ..spans import span
from .layers import MLP, _init, mlp_apply


class MoE(nn.Module):
    """``router (D, E)`` in fp32 whatever the model's dtype, ``gate`` and
    ``up (E, D, F)``, ``down (E, F, D)`` and, with ``shared_d_ff``, one
    ungated ``shared`` SwiGLU MLP: the reference's names, shapes and
    scales."""

    AXES = {"router": ("embed", "experts"), "gate": ("experts", "embed", "mlp"),
            "up": ("experts", "embed", "mlp"), "down": ("experts", "mlp", "embed")}

    def __init__(self, d_model, moe_d_ff, n_experts, dtype, shared_d_ff=0, device=None,
                 generator=None):
        super().__init__()
        s = 1.0 / math.sqrt(d_model)
        E, D, Fd = n_experts, d_model, moe_d_ff
        self.router = nn.Parameter(_init((D, E), s, torch.float32, device, generator))
        self.gate = nn.Parameter(_init((E, D, Fd), s, dtype, device, generator))
        self.up = nn.Parameter(_init((E, D, Fd), s, dtype, device, generator))
        self.down = nn.Parameter(_init((E, Fd, D), 1.0 / math.sqrt(Fd), dtype, device,
                                       generator))
        if shared_d_ff:
            self.shared = MLP(D, shared_d_ff, dtype, device, generator)


def moe_init(generator, d_model, moe_d_ff, n_experts, dtype, shared_d_ff=0,
             device=None) -> MoE:
    return MoE(d_model, moe_d_ff, n_experts, dtype, shared_d_ff, device, generator)


def capacity(T: int, n_top: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert: the reference's Python float arithmetic, at least 1."""
    return max(1, int(math.ceil(capacity_factor * T * n_top / n_experts)))


def _dispatch_ffn(p, xt, n_top: int, capacity_factor: float):
    """xt: (T, D) tokens. Returns (y (T, D) in the experts' dtype, aux).

    Each token goes to its ``n_top`` most probable experts (fp32 router
    softmax, top-k weights renormalised). The T·k assignments are sorted by
    expert, stably, so within an expert they keep token order; an
    assignment whose rank in its expert reaches the capacity C is dropped
    (sent to a spare row ``E·C`` that is never read). The experts run on
    their ``(C, D)`` slices as batched products.

    The combine is deterministic: each token's k weighted expert outputs
    are gathered into ``(T, k, D)`` in ascending expert order (the order in
    which the reference's ``zeros.at[st].add`` applies its sorted updates)
    and added left to right in the experts' dtype. (``index_add_`` would
    add them by atomics on CUDA, in an order that changes from run to run.)

    ``aux`` is the Switch load-balancing loss ``E·Σ frac_tokens·frac_probs``,
    a 0-d fp32 tensor."""
    T, D = xt.shape
    E = p.router.shape[1]
    dev = xt.device
    probs = torch.softmax(xt.float() @ p.router, dim=-1)           # (T, E)
    topv, topi = torch.topk(probs, n_top, dim=-1)                   # (T, k)
    topv = topv / topv.sum(-1, keepdim=True)
    n = T * n_top
    flat_e = topi.reshape(-1)
    flat_w = topv.reshape(-1)
    ar = torch.arange(n, device=dev)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], ar[order] // n_top, flat_w[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = ar - starts[se]
    C = capacity(T, n_top, E, capacity_factor)
    keep = rank < C
    dst = torch.where(keep, se * C + rank, E * C)                   # drop row E*C
    buf = xt.new_zeros((E * C + 1, D)).index_copy(0, dst, xt[st])
    xe = buf[:E * C].reshape(E, C, D)
    g = torch.bmm(xe, p.gate)
    u = torch.bmm(xe, p.up)
    ye = torch.bmm(F.silu(g) * u, p.down)
    contrib = torch.cat([ye.reshape(E * C, D), ye.new_zeros((1, D))])[dst]
    contrib = contrib * (sw * keep)[:, None].to(ye.dtype)           # sorted order
    # each assignment's place in the sorted order; then each token's k
    # places in ascending expert order
    place = torch.empty_like(order).scatter_(0, order, ar)
    asc = torch.argsort(topi, dim=-1)
    picks = contrib[place[torch.arange(T, device=dev)[:, None] * n_top + asc]]  # (T, k, D)
    y = picks[:, 0]
    for i in range(1, n_top):
        y = y + picks[:, i]
    frac_tokens = counts.float() / n
    frac_probs = probs.mean(0)
    aux = E * (frac_tokens * frac_probs).sum()
    return y, aux


def dropless_ffn(p, xt, n_top: int):
    """xt: (T, D) tokens. Returns (T, D) in the experts' dtype, every one of
    the T·k assignments computed: no capacity and nothing dropped.

    Each token goes to the ``n_top`` experts of largest fp32 router logit,
    weighted by the softmax over those logits (the renormalised top-k of the
    full softmax). The assignments are sorted by expert, stably; the counts
    (``index_add_``) and their running sums stay on the device. The gate,
    up and down products are grouped products over the sorted rows, each one
    ``torch._grouped_mm`` with the group ends on the device (on the card
    CUTLASS's sm90 grouped GEMM for bf16; on the CPU any float dtype, forward
    and backward), the routing weight applied before the down product; an
    expert with no rows reads none of its weights.
    The combine is the capacity path's: each token's k outputs added left to
    right in ascending expert order, in the experts' dtype. On the card
    nothing here waits for the device."""
    T, D = xt.shape
    E = p.router.shape[1]
    n = T * n_top
    dev = xt.device
    with span("moe.route", tokens=T, assignments=n):
        topl, topi = torch.topk(xt.float() @ p.router, n_top, dim=-1)   # (T, k)
        topi, asc = torch.sort(topi, dim=-1)            # each token's experts ascending
        w = torch.softmax(topl.gather(-1, asc), dim=-1)
        flat_e = topi.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        counts = torch.zeros(E, dtype=torch.int32, device=dev).index_add_(
            0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
        ends = torch.cumsum(counts, 0, dtype=torch.int32)
        # each assignment's row in the sorted order, (T, k)
        place = torch.empty_like(order).scatter_(0, order, torch.arange(n, device=dev))
        place = place.view(T, n_top)
    with span("moe.experts", tokens=T, experts=E):
        xs = xt[order // n_top]
        h = F.silu(torch._grouped_mm(xs, p.gate, offs=ends)) \
            * torch._grouped_mm(xs, p.up, offs=ends)
        ys = torch._grouped_mm(h * w.reshape(-1)[order, None].to(h.dtype), p.down, offs=ends)
        y = ys[place[:, 0]]
        for j in range(1, n_top):
            y = y + ys[place[:, j]]
    return y


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over ``group`` forward; the gradient, the same on
    every rank of the group, passes unchanged (the reference's ``psum``
    under ``shard_map``)."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _FirstShard(torch.autograd.Function):
    """The value of the rank at mesh coordinate 0 on every rank; backward,
    each rank's gradient divided by ``n``, the ranks whose parts of the
    router's gradient are added (so the router gets the mean over data
    shards of their aux's gradients, as under the reference's unchecked
    ``out_specs=P()``)."""

    @staticmethod
    def forward(ctx, aux, src, n):
        ctx.n = n
        aux = aux.detach().clone()
        dist.broadcast(aux, src=src)
        return aux

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _moe_sharded(p, x, n_top, capacity_factor, mesh):
    """The reference's ``shard_map`` branch: one dispatch per data shard,
    the experts' ``F`` split over ``model`` when the rules' ``mlp`` is
    ``model`` and ``F`` divides."""
    B = x.shape[0]
    shape = mesh_shape(mesh)
    bax = batch_axes(mesh, B)          # () when B doesn't divide -> replicate
    F_ = p.gate.shape[2]
    mlp_ax = current_rules().get("mlp")
    tp = mlp_ax if isinstance(mlp_ax, str) else None
    if not (tp and tp in shape and F_ % shape[tp] == 0):
        tp = None
    n_parts = math.prod(shape[a] for a in bax) * (shape[tp] if tp else 1)
    src = int(mesh.mesh.flatten()[0])
    if dist.get_world_size() != mesh.mesh.numel():
        raise ValueError("moe_apply: the mesh must hold every rank of the process group")

    def body(router, gate, up, down, xl):
        Bl, Sl, Dl = xl.shape
        w = SimpleNamespace(router=router, gate=gate, up=up, down=down)
        yl, aux = _dispatch_ffn(w, xl.reshape(Bl * Sl, Dl), n_top, capacity_factor)
        if tp is not None:
            # TP reduction after the scatter-back: the (T, D) output, not the
            # (E, C, D) dispatch buffer
            yl = _SumOver.apply(yl, mesh.get_group(tp))
        return yl.reshape(Bl, Sl, Dl), _FirstShard.apply(aux, src, n_parts)

    xspec = (spec_entry(bax), None, None)
    by_data, by_model = tuple(bax), (tp,) if tp else ()
    fn = shard_map(body, mesh,
                     in_specs=((), (None, None, tp), (None, None, tp), (None, tp, None), xspec),
                     out_specs=[xspec, ()],
                     partial_grads=[by_data + by_model, by_data, by_data, by_data, by_model])
    return fn(p.router, p.gate, p.up, p.down, x)


def moe_apply(p, x, *, n_top: int, capacity_factor: float = 1.25, dropless: bool = False):
    """x: (B, S, D) -> ((B, S, D), aux). Without a mesh the B·S tokens are
    dispatched together (the reference's unpartitioned branch); under a
    mesh with a ``model`` axis, per data shard (``_moe_sharded``). With
    ``dropless`` (the ``moe_hybrid`` family's), by ``dropless_ffn``,
    unsharded, and aux is 0.0. The shared experts, if present, are added."""
    B, S, D = x.shape
    mesh = current_mesh()
    if dropless:
        if mesh is not None and "model" in mesh_shape(mesh):
            raise NotImplementedError("moe_apply: the dropless dispatch has no sharded form")
        y, aux = dropless_ffn(p, x.reshape(B * S, D), n_top).reshape(B, S, D), 0.0
    elif mesh is None or "model" not in mesh_shape(mesh):
        y, aux = _dispatch_ffn(p, x.reshape(B * S, D), n_top, capacity_factor)
        y = y.reshape(B, S, D)
    else:
        y, aux = _moe_sharded(p, x, n_top, capacity_factor, mesh)
    if hasattr(p, "shared"):
        y = y + mlp_apply(p.shared, x)
    return y, aux
