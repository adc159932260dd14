"""Decoder transformer, dense llama-style branch (GQA/MQA, optional sliding
window). Mirror of ``repro.models.transformer``: init / loss / prefill /
decode_step. Layers are a Python loop over a ``ModuleList``; each layer's
parameters keep the reference's per-layer shapes (the reference stacks them
on a leading ``layers`` axis, ``repro_torch.convert`` splits it).

MoE, the ``embeds`` input mode and the VLM prefix are not ported yet
(ROADMAP Queue 1, items 11 and 12).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from .attention import (Attention, KVCache, cache_capacity, decode_attn,
                        multihead_attn)
from .layers import (MLP, _init, embed_init, embed_lookup, mlp_apply, pad_vocab,
                     remat, rmsnorm, rmsnorm_init, softmax_xent)


def _head_dim(cfg):
    return getattr(cfg, "head_dim", 0) or cfg.d_model // cfg.n_heads


def _check_dense(cfg):
    if cfg.n_experts:
        raise NotImplementedError("MoE blocks are not ported yet (ROADMAP Queue 1, item 11)")
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"input_mode={cfg.input_mode!r} is not ported yet "
                                  "(ROADMAP Queue 1, item 12)")


class Block(nn.Module):
    def __init__(self, cfg, dtype, device=None, generator=None):
        super().__init__()
        _check_dense(cfg)
        self.ln1 = rmsnorm_init(cfg.d_model, device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              _head_dim(cfg), dtype, device, generator)
        self.ln2 = rmsnorm_init(cfg.d_model, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device, generator)


def block_init(generator, cfg, dtype, device=None) -> Block:
    return Block(cfg, dtype, device, generator)


def block_apply(p, h, cfg, positions, *, return_kv=False):
    """Returns (h, aux), or (h, aux, (k, v)) with ``return_kv``."""
    a = multihead_attn(
        p.attn, rmsnorm(h, p.ln1, cfg.norm_eps), positions,
        causal=cfg.causal, window=cfg.sliding_window,
        rope_theta=cfg.rope_theta, use_flash=cfg.use_flash,
        return_kv=return_kv)
    a, kv = a if return_kv else (a, None)
    h = h + a
    h = h + mlp_apply(p.mlp, rmsnorm(h, p.ln2, cfg.norm_eps))
    return (h, 0.0, kv) if return_kv else (h, 0.0)


class Transformer(nn.Module):
    """``embed (Vpad, D)``, ``layers``, ``final_norm (D,)`` and, unless the
    embeddings are tied, ``head (D, Vpad)``. ``generator=None`` leaves the
    weights uninitialised (they are about to be loaded)."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        dtype = cfg.dtype
        vpad = pad_vocab(cfg.vocab_size)
        self.embed = embed_init(generator, vpad, cfg.d_model, dtype, device)
        self.layers = nn.ModuleList(
            Block(cfg, dtype, device, generator) for _ in range(cfg.n_layers))
        self.final_norm = rmsnorm_init(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(_init((cfg.d_model, vpad),
                                           1.0 / math.sqrt(cfg.d_model), dtype,
                                           device, generator))


def transformer_init(generator, cfg, device=None) -> Transformer:
    return Transformer(cfg, device, generator)


def _scan_layers(params, cfg, h, positions):
    """Every block in turn; with ``cfg.remat`` each one is checkpointed.
    (The reference also sums the blocks' MoE aux losses: dense blocks have
    none.)"""
    for lp in params.layers:
        h, _ = remat(cfg.remat, block_apply, lp, h, cfg, positions)
    return h


def _logits(params, cfg, h):
    if cfg.tie_embeddings:
        return h @ params.embed.t()
    return h @ params.head


def _embed_inputs(params, cfg, batch):
    _check_dense(cfg)
    return embed_lookup(params.embed, batch["tokens"])


def transformer_loss(params, cfg, batch):
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["targets"]`` (-1 ignored), a 0-d fp32 tensor."""
    h = _embed_inputs(params, cfg, batch)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device).expand(B, S)
    h = _scan_layers(params, cfg, h, positions)
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    return softmax_xent(_logits(params, cfg, h), batch["targets"], cfg.vocab_size)


# --------------------------------------------------------------------------
# Serving
# --------------------------------------------------------------------------
class DecodeState(NamedTuple):
    caches: KVCache     # stacked (L, ...) tensors
    pos: int            # next position to write


def init_cache(cfg, batch, seq_len, dtype, device=None):
    cap = cache_capacity(seq_len, cfg.sliding_window)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, _head_dim(cfg)
    return KVCache(
        k=torch.zeros((L, batch, cap, KV, hd), dtype=dtype, device=device),
        v=torch.zeros((L, batch, cap, KV, hd), dtype=dtype, device=device),
        slot_pos=torch.full((L, cap), -1, dtype=torch.int32, device=device))


def transformer_prefill(params, cfg, batch, cache_len):
    """Run the prompt, fill the KV cache. Returns (last logits, DecodeState).
    Each layer's K/V come from its attention call; the last ``cap``
    positions are written to the cache (rolling for SWA)."""
    h = _embed_inputs(params, cfg, batch)
    B, S, _ = h.shape
    device = h.device
    positions = torch.arange(S, device=device).expand(B, S)
    caches = init_cache(cfg, B, cache_len, cfg.dtype, device)
    cap = caches.k.shape[2]
    take = min(S, cap)
    slot0 = (S - take) % cap if cfg.sliding_window else 0
    slots = (torch.arange(take, device=device) + slot0) % cap
    for i, lp in enumerate(params.layers):
        h, _, (k, v) = block_apply(lp, h, cfg, positions, return_kv=True)
        caches.k[i][:, slots] = k[:, S - take:]
        caches.v[i][:, slots] = v[:, S - take:]
    caches.slot_pos[:, slots] = torch.arange(S - take, S, dtype=torch.int32,
                                             device=device)
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    return _logits(params, cfg, h[:, -1]), DecodeState(caches, S)


def transformer_decode_step(params, cfg, state: DecodeState, tokens):
    """tokens: (B,) int. One decode step. Returns (logits, new state); the
    caches are updated in place."""
    h = embed_lookup(params.embed, tokens)                       # (B, D)
    pos, c = state.pos, state.caches
    for i, lp in enumerate(params.layers):
        a, _ = decode_attn(lp.attn, rmsnorm(h, lp.ln1, cfg.norm_eps),
                           KVCache(c.k[i], c.v[i], c.slot_pos[i]), pos,
                           window=cfg.sliding_window, rope_theta=cfg.rope_theta)
        h = h + a
        h = h + mlp_apply(lp.mlp, rmsnorm(h, lp.ln2, cfg.norm_eps))
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    return _logits(params, cfg, h), DecodeState(c, pos + 1)
