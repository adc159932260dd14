"""Plain AdamW for the training references: decoupled weight decay on every
parameter, global-norm clipping, bias correction, linear warm-up then a
cosine to ``min_lr_frac`` of the rate. The moments are float32; each
parameter is stored back in its own dtype after the step, as the
configuration states it (bf16 matrices, float32 norms)."""
from __future__ import annotations

import math

import torch


def rate(o: dict, step: int) -> float:
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    prog = min(max((step - o["warmup_steps"]) / max(o["total_steps"] - o["warmup_steps"], 1),
                   0.0), 1.0)
    return o["lr"] * warm * (o["min_lr_frac"] + (1 - o["min_lr_frac"])
                             * 0.5 * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def step(params: dict, grads: dict, state: dict, o: dict, count: int):
    """One AdamW step at ``count`` (1 for the first) on ``params`` (tensors
    in their stored dtype, updated in place); ``state`` holds ``m`` and
    ``v`` dicts. Returns the clipped gradients (float32)."""
    gnorm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
    scale = min(o["grad_clip"] / (gnorm + 1e-9), 1.0) if o["grad_clip"] else 1.0
    lr = rate(o, count)
    b1c, b2c = 1 - o["b1"] ** count, 1 - o["b2"] ** count
    clipped = {}
    for k, p in params.items():
        g = grads[k].float() * scale
        clipped[k] = g
        m = state["m"].setdefault(k, torch.zeros_like(g))
        v = state["v"].setdefault(k, torch.zeros_like(g))
        m.mul_(o["b1"]).add_((1 - o["b1"]) * g)
        v.mul_(o["b2"]).add_((1 - o["b2"]) * g.square())
        p32 = p.float()
        upd = (m / b1c) / (torch.sqrt(v / b2c) + o["eps"]) + o["weight_decay"] * p32
        p.copy_(p32 - lr * upd)
    return clipped
