"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule. Mirror of ``repro.optim.adamw``, written out by hand rather than
through ``torch.optim.AdamW``, whose order of operations and bias
correction differ from the reference's.

Trees are dicts of tensors keyed by the model's ``state_dict`` names. The
moments ``m`` and ``v`` are fp32 for every parameter, bf16 ones included;
``count`` is a 0-d int32 tensor on the parameters' device, so the schedule
and the bias correction never wait for the host.

The parameters may be DTensors (``distributed.place``). ``adamw_init``'s
moments follow the parameters' placements, as the reference's state follows
the parameters' logical sharding; moments laid out otherwise (a strategy's
``OPT_RULES``) are taken as they are. Each gradient and parameter is laid
out like its moments, the update runs on each rank's shard (and goes back
onto the parameter's layout), and ``global_norm`` adds every shard's
squares (a ``Partial`` sum, all-reduced), so clipping uses the norm of the
whole tree.

On the card the update is two multi-tensor kernels (``kernels/adamw``),
three launches for a tree of up to 512 leaves, in place of ~24 small
kernels a leaf; the step's scalars (count, schedule, bias corrections,
clip scale) stay torch ops on 0-d device tensors, which the kernels read
through their pointers. ``adamw_update_plain`` keeps the loop, for CPU and
``meta`` trees and as the kernels' reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from ..kernels import adamw as adamw_kernels
from ..spans import span


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: torch.Tensor


def adamw_init(params: dict) -> AdamWState:
    zeros = {k: torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
             for k, p in params.items()}
    device = next(iter(params.values())).device
    return AdamWState(m=zeros, v={k: torch.zeros_like(z) for k, z in zeros.items()},
                      count=torch.zeros((), dtype=torch.int32, device=device))


def schedule(cfg: AdamWConfig, step):
    """Linear warmup to ``cfg.lr``, then a cosine down to ``min_lr_frac`` of
    it at ``total_steps``; fp32, as the reference computes it."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: dict):
    """The 2-norm of every tensor of ``tree`` together, a 0-d fp32 tensor. A
    DTensor's sum of squares is a ``Partial`` sum; those with one layout
    are added first, then each is all-reduced once."""
    sums: dict = {}
    for t in tree.values():
        sq = t.float().square().sum()
        key = (sq.device_mesh, tuple(sq.placements)) if isinstance(sq, DTensor) else None
        sums[key] = sums[key] + sq if key in sums else sq
    return torch.sqrt(sum(s.full_tensor() if isinstance(s, DTensor) else s
                          for s in sums.values()))


def _local(p, g, m, v):
    """This rank's shards of a DTensor parameter, its gradient and its
    moments, the parameter and the gradient laid out like the moments first
    (a strategy's ``OPT_RULES`` may shard the moments differently, ZeRO-1
    style); plain tensors as they are. Returns them and the laid-out
    parameter (``p`` itself where the layouts agree)."""
    if not isinstance(p, DTensor):
        return p, g, m, v, p
    mesh, placements = m.device_mesh, tuple(m.placements)
    if tuple(g.placements) != placements:
        g = g.redistribute(mesh, placements)
    pm = p if tuple(p.placements) == placements else p.redistribute(mesh, placements)
    return pm.to_local(), g.to_local(), m.to_local(), v.to_local(), pm


def _check(grads, params):
    missing = [k for k in params if grads.get(k) is None]
    if missing:
        raise ValueError(f"adamw_update: no gradient for {missing}")


def _prelude(grads, state, cfg, norm):
    """The step's scalars, 0-d device tensors computed by torch ops (no host
    sync): (count, gnorm by ``norm``, the clip scale or 1.0, lr, b1c, b2c)."""
    count = state.count + 1
    gnorm = norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    lr = schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    return count, gnorm, scale, lr, b1c, b2c


def _back(param, pm):
    """A parameter laid out like its moments for the update (``_local``)
    goes back onto its own layout."""
    if pm is not param:
        param.to_local().copy_(pm.redistribute(param.device_mesh, param.placements).to_local())


@torch.no_grad()
def adamw_update_plain(grads: dict, params: dict, state: AdamWState, cfg: AdamWConfig):
    """``adamw_update`` as a loop of torch ops over the leaves, on any
    device: the path of CPU and ``meta`` trees, and on the card the
    reference that the kernels equal bit for bit when clipping is off."""
    _check(grads, params)
    count, gnorm, scale, lr, b1c, b2c = _prelude(grads, state, cfg, global_norm)
    for k in params:
        p, g, m, v, pm = _local(params[k], grads[k], state.m[k], state.v[k])
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        p32 = p.float()
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * step)
        _back(params[k], pm)
    return params, AdamWState(state.m, state.v, count), gnorm


def _copies(p, g, m) -> int:
    """The bytes of the copies that ``_local`` makes of a DTensor parameter
    and its gradient laid out otherwise than its moments (a strategy's
    ``OPT_RULES``, or a ``Partial`` gradient); 0 for plain tensors."""
    if not isinstance(p, DTensor):
        return 0
    like = tuple(m.placements)
    return ((tuple(p.placements) != like) * p.numel() * p.element_size()
            + (tuple(g.placements) != like) * g.numel() * g.element_size())


def _groups(grads, params, m) -> list:
    """The leaves' keys in groups of one update launch each: first every
    leaf that ``_local`` takes as it is, then those that it copies, in
    groups whose copies, alive until the group's update, hold no more bytes
    than the plain loop's fp32 copy of the largest leaf."""
    budget = 4 * max(p.numel() for p in params.values())
    copies = {k: _copies(params[k], grads[k], m[k]) for k in params}
    groups, held = [[k for k in params if not copies[k]]], budget
    for k in params:
        if copies[k]:
            if held + copies[k] > budget:
                groups.append([])
                held = 0
            groups[-1].append(k)
            held += copies[k]
    return [g for g in groups if g]


@torch.no_grad()
def adamw_update(grads: dict, params: dict, state: AdamWState, cfg: AdamWConfig):
    """One step. Returns (params, new state, gnorm) as the reference does,
    but the parameters and the moments are updated in place: a functional
    update would hold a second copy of each of them on the device.
    Weight decay applies to every parameter, norms included.

    A tree of CUDA leaves goes through the multi-tensor kernels
    (``kernels.adamw``): the update on each of them (on each rank's shards
    of a DTensor leaf), and the norm unless the gradients are DTensors,
    whose ``global_norm`` all-reduces the shards' sums. Leaves that
    ``_local`` copies take launches of their own (``_groups``), so that the
    copies alive at once stay within what the plain loop holds. Any other
    tree (CPU, ``meta``) takes the plain loop. The ``optim.adamw`` span
    counts both (``fused_leaves``, ``plain_leaves``)."""
    _check(grads, params)
    with span("optim.adamw") as attrs:
        if not params or not all(p.is_cuda for p in params.values()):
            attrs["fused_leaves"], attrs["plain_leaves"] = 0, len(params)
            return adamw_update_plain(grads, params, state, cfg)
        attrs["fused_leaves"], attrs["plain_leaves"] = len(params), 0
        groups = _groups(grads, params, state.m)
        leaves = [_local(params[k], grads[k], state.m[k], state.v[k]) for k in groups[0]]
        table = adamw_kernels.table(leaf[:4] for leaf in leaves)
        plain_grads = (grads.keys() == params.keys()
                       and not any(isinstance(g, DTensor) for g in grads.values()))
        count, gnorm, scale, lr, b1c, b2c = _prelude(
            grads, state, cfg,
            (lambda _: adamw_kernels.norm(table)) if plain_grads else global_norm)
        step = (scale if cfg.grad_clip else None, lr, b1c, b2c, cfg.b1, cfg.b2, cfg.eps,
                cfg.weight_decay)
        for i, group in enumerate(groups):
            if i:
                leaves = [_local(params[k], grads[k], state.m[k], state.v[k]) for k in group]
                table = adamw_kernels.table(leaf[:4] for leaf in leaves)
            adamw_kernels.update(table, *step)
            for k, leaf in zip(group, leaves):
                _back(params[k], leaf[4])
    return params, AdamWState(state.m, state.v, count), gnorm
