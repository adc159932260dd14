"""Decoder/encoder transformer family: dense llama-style (GQA/MQA, optional
sliding window), MoE variants, encoder-only (hubert) and VLM (llava) whose
modality frontends are stubs feeding precomputed embeddings. Mirror of
``repro.models.transformer``: init / loss / prefill / decode_step. Layers
are a Python loop over a ``ModuleList``; each layer's parameters keep the
reference's per-layer shapes (the reference stacks them on a leading
``layers`` axis, ``repro_torch.convert`` splits it).
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
from .moe import MoE, moe_apply


def _head_dim(cfg):
    return getattr(cfg, "head_dim", 0) or cfg.d_model // cfg.n_heads


class Block(nn.Module):
    """``ln1``, ``attn``, ``ln2`` and either ``moe`` (``cfg.n_experts``) or
    ``mlp``."""

    def __init__(self, cfg, dtype, device=None, generator=None):
        super().__init__()
        self.ln1 = rmsnorm_init(cfg.d_model, device)
        self.attn = Attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              _head_dim(cfg), dtype, device, generator)
        self.ln2 = rmsnorm_init(cfg.d_model, device)
        if cfg.n_experts:
            self.moe = MoE(cfg.d_model, cfg.moe_d_ff, cfg.n_experts, dtype,
                           cfg.shared_d_ff, device, generator)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype, device, generator)


def block_init(generator, cfg, dtype, device=None) -> Block:
    return Block(cfg, dtype, device, generator)


def block_apply(p, h, cfg, positions, *, return_kv=False):
    """Returns (h, aux), or (h, aux, (k, v)) with ``return_kv``; aux is the
    MoE load-balancing loss, 0.0 for a dense block."""
    a = multihead_attn(
        p.attn, rmsnorm(h, p.ln1, cfg.norm_eps), positions,
        causal=cfg.causal, window=cfg.sliding_window,
        rope_theta=cfg.rope_theta, use_flash=cfg.use_flash,
        return_kv=return_kv)
    a, kv = a if return_kv else (a, None)
    h = h + a
    ff_in = rmsnorm(h, p.ln2, cfg.norm_eps)
    if cfg.n_experts:
        ff, aux = moe_apply(p.moe, ff_in, n_top=cfg.n_experts_per_tok)
    else:
        ff, aux = mlp_apply(p.mlp, ff_in), 0.0
    h = h + ff
    return (h, aux, kv) if return_kv else (h, aux)


class Transformer(nn.Module):
    """``embed (Vpad, D)`` (not for ``input_mode == "embeds"``: the encoder
    is fed frame embeddings), ``layers``, ``final_norm (D,)`` and, unless
    the embeddings are tied, ``head (D, Vpad)``. ``generator=None`` leaves
    the weights uninitialised (they are about to be loaded)."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        dtype = cfg.dtype
        vpad = pad_vocab(cfg.vocab_size)
        if cfg.input_mode in ("tokens", "vlm"):
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
    Returns (h, the blocks' MoE aux losses summed; 0.0 for dense blocks)."""
    aux = 0.0
    for lp in params.layers:
        h, a = remat(cfg.remat, block_apply, lp, h, cfg, positions)
        aux = aux + a
    return h, aux


def _logits(params, cfg, h):
    if cfg.tie_embeddings:
        return h @ params.embed.t()
    return h @ params.head


def _embed_inputs(params, cfg, batch):
    if cfg.input_mode == "tokens":
        return embed_lookup(params.embed, batch["tokens"])
    if cfg.input_mode == "embeds":            # encoder/audio frontend stub
        return batch["embeds"].to(cfg.dtype)
    if cfg.input_mode == "vlm":               # vision stub + text tokens
        txt = embed_lookup(params.embed, batch["tokens"])
        return torch.cat([batch["vision_embeds"].to(cfg.dtype), txt], dim=1)
    raise ValueError(cfg.input_mode)


def transformer_loss(params, cfg, batch):
    """Mean cross-entropy of the logits against ``batch["targets"]`` (-1
    ignored), a 0-d fp32 tensor; for the VLM only over the text positions
    after the vision prefix; for MoE plus ``moe_aux_weight`` times the
    blocks' mean load-balancing loss."""
    h = _embed_inputs(params, cfg, batch)
    B, S, _ = h.shape
    positions = torch.arange(S, device=h.device).expand(B, S)
    h, aux = _scan_layers(params, cfg, h, positions)
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    if cfg.input_mode == "vlm":               # loss over the text tail only
        h = h[:, batch["vision_embeds"].shape[1]:]
    loss = softmax_xent(_logits(params, cfg, h), batch["targets"], cfg.vocab_size)
    if cfg.n_experts:
        loss = loss + cfg.moe_aux_weight * aux / cfg.n_layers
    return loss


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
        ff_in = rmsnorm(h, lp.ln2, cfg.norm_eps)
        if cfg.n_experts:                    # the B new tokens dispatched together
            ff, _ = moe_apply(lp.moe, ff_in[:, None], n_top=cfg.n_experts_per_tok)
            ff = ff[:, 0]
        else:
            ff = mlp_apply(lp.mlp, ff_in)
        h = h + ff
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    return _logits(params, cfg, h), DecodeState(c, pos + 1)
