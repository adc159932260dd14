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
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

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


@torch.no_grad()
@span("optim.adamw")
def adamw_update(grads: dict, params: dict, state: AdamWState, cfg: AdamWConfig):
    """One step. Returns (params, new state, gnorm) as the reference does,
    but the parameters and the moments are updated in place: a functional
    update would hold a second copy of each of them on the device.
    Weight decay applies to every parameter, norms included."""
    missing = [k for k in params if grads.get(k) is None]
    if missing:
        raise ValueError(f"adamw_update: no gradient for {missing}")
    count = state.count + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    lr = schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()
    for k in params:
        p, g, m, v, pm = _local(params[k], grads[k], state.m[k], state.v[k])
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        p32 = p.float()
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * step)
        if pm is not params[k]:     # back onto the parameter's own layout
            params[k].to_local().copy_(
                pm.redistribute(params[k].device_mesh, params[k].placements).to_local())
    return params, AdamWState(state.m, state.v, count), gnorm
