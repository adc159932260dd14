"""Shared building blocks: norms, RoPE, SwiGLU MLP, embedding, inits.

Mirror of ``repro.models.layers``. Parameters keep the reference's shapes
(``gate`` is ``(d_model, d_ff)``, not ``nn.Linear``'s transpose), so a JAX
param tree converts by a rename (``repro_torch.convert``). Functions take
the module whose attributes hold the tensors where the reference takes a
param dict.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _init(shape, scale, dtype, device, generator):
    """N(0, 1) * scale drawn in fp32, then cast (as the reference's _init).
    ``generator=None`` leaves the tensor uninitialised, for a module that
    is about to be loaded from converted weights."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (t * scale).to(dtype)


def rmsnorm_init(d, device=None) -> nn.Parameter:
    # norm weights stay fp32 even in a bf16 model
    return nn.Parameter(torch.ones((d,), dtype=torch.float32, device=device))


def rmsnorm(x, w, eps=1e-5):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w).to(dt)


# --------------------------------------------------------------------------
# RoPE: split halves (not interleaved pairs), fp32 angles
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float = 10000.0) -> torch.Tensor:
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    return torch.from_numpy(inv)  # (head_dim/2,)


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    # kept on the device: a host-to-device copy per call would make every
    # decode step wait for the card twice a layer
    return rope_freqs(head_dim, theta).to(device)


def apply_rope(x, positions, theta=10000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    inv = _rope_freqs_on(hd, float(theta), x.device)
    ang = positions[..., :, None].float() * inv              # (..., S, hd/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, d_model, d_ff, dtype, device=None, generator=None):
        super().__init__()
        s_in, s_ff = 1 / math.sqrt(d_model), 1 / math.sqrt(d_ff)
        self.gate = nn.Parameter(_init((d_model, d_ff), s_in, dtype, device, generator))
        self.up = nn.Parameter(_init((d_model, d_ff), s_in, dtype, device, generator))
        self.down = nn.Parameter(_init((d_ff, d_model), s_ff, dtype, device, generator))


def mlp_init(generator, d_model, d_ff, dtype, device=None) -> MLP:
    return MLP(d_model, d_ff, dtype, device, generator)


def mlp_apply(p, x):
    h = F.silu(x @ p.gate) * (x @ p.up)
    return h @ p.down


# --------------------------------------------------------------------------
# Embedding
# --------------------------------------------------------------------------
def pad_vocab(v: int, multiple: int = 128) -> int:
    return ((v + multiple - 1) // multiple) * multiple


def embed_init(generator, vocab_padded, d_model, dtype, device=None):
    return nn.Parameter(_init((vocab_padded, d_model), 1.0, dtype, device, generator))


def embed_lookup(table, tokens):
    """``jnp.take(table, tokens, axis=0)`` for in-range token ids."""
    return F.embedding(tokens, table)
