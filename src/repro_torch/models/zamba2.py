"""Zamba2-style hybrid: a Mamba2 backbone with a *shared* attention block
(one set of weights) applied every ``attn_every`` layers (arXiv:2411.15242).
Mirror of ``repro.models.zamba2``.

The shared block attends over concat(hidden, initial_embedding), ``2·D``
wide, and writes ``D`` back: the Zamba trick that lets one block serve many
depths. Per-application LoRA deltas are omitted, as in the reference.

The layers run segment by segment: the shared block at each site, then the
Mamba layers up to the next site. Under ``cfg.remat`` only the Mamba layers
are checkpointed, as the reference checkpoints only its scan body, so a
train step runs the SSD kernel twice a layer and the flash kernel once a
site.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..distributed import shard_activation
from ..distributed.sharding import place_state
from .attention import (KV_CACHE_AXES, Attention, KVCache, cache_capacity, decode_attn,
                        multihead_attn)
from .layers import MLP, _init, embed_init, mlp_apply, pad_vocab, remat, rmsnorm, rmsnorm_init
from .mamba2 import MAMBA_CACHE_AXES, MambaCache, SSMLayer, mamba2_decode, ssm_layer


def _sites(cfg) -> list[int]:
    return list(range(0, cfg.n_layers, cfg.attn_every))


def _segments(cfg) -> list[tuple[int, int]]:
    """``(site, end)``: the layers ``site..end-1`` follow the shared block
    applied at ``site``."""
    sites = _sites(cfg)
    return [(s, sites[i + 1] if i + 1 < len(sites) else cfg.n_layers)
            for i, s in enumerate(sites)]


class SharedBlock(Attention):
    """``ln1 (2D,)``, ``q (2D,H,hd)``, ``k``/``v`` ``(2D,KV,hd)``,
    ``o (H,hd,D)``, ``ln2 (D,)`` and ``mlp``: the reference's ``shared``
    dict, its attention weights at the top level as there."""

    AXES = {**Attention.AXES, "ln1": ("norm",), "ln2": ("norm",)}

    def __init__(self, cfg, device=None, generator=None):
        D, H = cfg.d_model, cfg.n_heads
        super().__init__(2 * D, H, cfg.n_kv_heads, D // H, cfg.dtype, device, generator,
                         d_out=D)
        self.ln1 = rmsnorm_init(2 * D, device)
        self.ln2 = rmsnorm_init(D, device)
        self.mlp = MLP(D, cfg.d_ff, cfg.dtype, device, generator)


def _shared_attn_full(p, h, h0, cfg, positions):
    a_in = rmsnorm(torch.cat([h, h0], dim=-1), p.ln1, cfg.norm_eps)
    h = h + multihead_attn(p, a_in, positions, causal=True, window=cfg.sliding_window,
                           rope_theta=cfg.rope_theta, use_flash=cfg.use_flash)
    return h + mlp_apply(p.mlp, rmsnorm(h, p.ln2, cfg.norm_eps))


def _shared_attn_step(p, h, h0, cfg, cache: KVCache, pos: int):
    """h, h0: (B, D). Returns (h, cache); the cache is updated in place."""
    a_in = rmsnorm(torch.cat([h, h0], dim=-1), p.ln1, cfg.norm_eps)     # (B, 2D)
    a, cache = decode_attn(p, a_in, cache, pos, window=cfg.sliding_window,
                           rope_theta=cfg.rope_theta)
    h = h + a
    return h + mlp_apply(p.mlp, rmsnorm(h, p.ln2, cfg.norm_eps)), cache


class Zamba2(nn.Module):
    """``embed (Vpad, D)``, ``mamba_layers``, ``shared``, ``final_norm (D,)``
    and, unless the embeddings are tied, ``head (D, Vpad)``.
    ``generator=None`` leaves the drawn weights uninitialised (they are
    about to be loaded)."""

    AXES = {"embed": ("vocab", "embed"), "final_norm": ("norm",), "head": ("embed", "vocab")}

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        vpad = pad_vocab(cfg.vocab_size)
        self.embed = embed_init(generator, vpad, cfg.d_model, cfg.dtype, device)
        self.mamba_layers = nn.ModuleList(
            SSMLayer(cfg, device, generator) for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, device, generator)
        self.final_norm = rmsnorm_init(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(_init((cfg.d_model, vpad),
                                           1.0 / math.sqrt(cfg.d_model), cfg.dtype,
                                           device, generator))


def zamba2_forward(params, cfg, h, positions):
    """h: (B, S, D) embedded tokens -> (B, S, D). S must be a multiple of
    ``cfg.ssm_chunk``."""
    h = shard_activation(h)
    h0 = h
    for lo, hi in _segments(cfg):
        h = _shared_attn_full(params.shared, h, h0, cfg, positions)
        for lp in params.mamba_layers[lo:hi]:
            h = shard_activation(h)
            h = remat(cfg.remat, ssm_layer, lp, h, cfg)
    return h


class HybridState(NamedTuple):
    mamba: MambaCache   # stacked (L, ...) tensors
    attn: KVCache       # stacked (n_sites, ...) tensors
    pos: int


def zamba2_init_state(cfg, batch, cache_len, dtype, device=None) -> HybridState:
    """Empty caches: zero conv windows and states, empty KV slots, pos 0;
    under a mesh laid out by their logical axes."""
    n_sites = len(_sites(cfg))
    m = MambaCache.init(batch, cfg.d_model, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                        ssm_state=cfg.ssm_state, dtype=dtype, device=device)
    m = MambaCache(*(t.expand(cfg.n_layers, *t.shape).clone() for t in m))
    cap = cache_capacity(cache_len, cfg.sliding_window)
    a = KVCache.init(batch, cap, cfg.n_kv_heads, cfg.d_model // cfg.n_heads, dtype, device)
    a = KVCache(*(t.expand(n_sites, *t.shape).clone() for t in a))
    return HybridState(place_state(m, MAMBA_CACHE_AXES), place_state(a, KV_CACHE_AXES), 0)


def zamba2_decode_step(params, cfg, state: HybridState, h):
    """h: (B, D) embedded token. Returns (h_out, new state); the caches are
    updated in place."""
    h0, pos = h, state.pos
    m, a = state.mamba, state.attn
    for si, (lo, hi) in enumerate(_segments(cfg)):
        h, _ = _shared_attn_step(params.shared, h, h0, cfg,
                                 KVCache(a.k[si], a.v[si], a.slot_pos[si]), pos)
        for i in range(lo, hi):
            lp = params.mamba_layers[i]
            out, _ = mamba2_decode(lp, rmsnorm(h, lp.ln, cfg.norm_eps),
                                   MambaCache(m.conv_x[i], m.conv_bc[i], m.h[i]))
            h = h + out
    return h, HybridState(m, a, pos + 1)
