"""Mixture-of-Experts FFN (mixtral-style top-k routed + qwen-style shared
experts) with sort-based token dispatch and capacity dropping. Mirror of
``repro.models.moe``.

The reference runs the dispatch under ``shard_map`` when a mesh with a
``model`` axis is active, and unpartitioned otherwise. The port has no mesh
yet (the distributed layer is ROADMAP Queue 1 item 13), so only the
unpartitioned branch is here.

The expert products are batched matrix products over the experts
(``torch.bmm``), as the reference leaves them to XLA's ``einsum``: the
reference has no kernel for MoE. On the card nothing here synchronises the
host: counts are built with ``index_add_``, the dropped assignments are
chosen with ``where`` and the capacity comes from Python ints, so a decode
step that calls the dispatch once a layer never waits for the device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, _init, mlp_apply


class MoE(nn.Module):
    """``router (D, E)`` in fp32 whatever the model's dtype, ``gate`` and
    ``up (E, D, F)``, ``down (E, F, D)`` and, with ``shared_d_ff``, one
    ungated ``shared`` SwiGLU MLP: the reference's names, shapes and
    scales."""

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


def moe_apply(p, x, *, n_top: int, capacity_factor: float = 1.25):
    """x: (B, S, D) -> ((B, S, D), aux). The B·S tokens are dispatched
    together (the reference's unpartitioned branch; its ``shard_map``
    branch, one dispatch per data shard, waits for the port's distributed
    layer). The shared experts, if present, are added."""
    B, S, D = x.shape
    y, aux = _dispatch_ffn(p, x.reshape(B * S, D), n_top, capacity_factor)
    y = y.reshape(B, S, D)
    if hasattr(p, "shared"):
        y = y + mlp_apply(p.shared, x)
    return y, aux
