"""The Granite 4.0-H hybrid (``granitemoehybrid``; family ``moe_hybrid``,
port-only: the JAX package has no twin). Layers of two kinds by
``cfg.layer_types``, Mamba2 mixers and attention mixers, each mixer
followed by a MoE:

    h = embedding_multiplier * embed[tokens]
    h = h + residual_multiplier * mixer(rmsnorm(h))
    h = h + residual_multiplier * moe(rmsnorm(h))          # every layer
    logits = rmsnorm(h) @ embed^T / logits_scaling

The family is the published model's, whatever the config: the Mamba2 mixer
is ``mamba2.py``'s (K2 with ``cfg.use_ssd_kernel``) with the published gate
order ``rmsnorm(y * silu(z))``; the attention mixer is ``attention.py``'s
(K1 with ``cfg.use_flash``) with no rotary embedding (NoPE) and the softmax
scale ``cfg.attn_scale``; the MoE is ``moe.py``'s dropless dispatch.

The decode state holds both kinds of state side by side: the Mamba2 layers'
conv windows and SSM states, stacked in layer order, the attention layers'
KV caches, stacked likewise, and ``pos``. The prefill leaves each conv
window at the prompt's last K-1 inputs, so that decode continues the prompt
as the published model does. Prompt lengths are multiples of
``cfg.ssm_chunk``. On the card a decode step is replayed from a CUDA graph
(``replay.py``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..distributed import shard_activation
from ..distributed.sharding import assign, place_state
from .attention import (KV_CACHE_AXES, Attention, KVCache, cache_capacity, decode_attn,
                        multihead_attn)
from .layers import (_init, embed_init, embed_lookup, pad_vocab, remat, rmsnorm, rmsnorm_init,
                     softmax_xent)
from .mamba2 import MAMBA_CACHE_AXES, Mamba2, MambaCache, mamba2_decode, mamba2_forward
from .moe import MoE, moe_apply
from . import replay
from .transformer import _head_dim, _logits
from .zamba2 import HybridState


def _kinds(cfg) -> list[tuple[str, int]]:
    """Each layer's kind ("mamba" | "attention") and its index among the
    layers of its kind (its slot in the decode state's stack)."""
    types = cfg.layer_types[:cfg.n_layers]
    if len(types) != cfg.n_layers or set(types) - {"mamba", "attention"}:
        raise ValueError(f"moe_hybrid: layer_types must give 'mamba' or 'attention' for each "
                         f"of the {cfg.n_layers} layers, got {cfg.layer_types!r}")
    seen = {"mamba": 0, "attention": 0}
    out = []
    for t in types:
        out.append((t, seen[t]))
        seen[t] += 1
    return out


class HybridMoELayer(nn.Module):
    """``ln1``, the mixer (``mamba`` or ``attn``), ``ln2`` and ``moe``."""

    AXES = {"ln1": ("norm",), "ln2": ("norm",)}

    def __init__(self, cfg, kind, device=None, generator=None):
        super().__init__()
        D = cfg.d_model
        self.ln1 = rmsnorm_init(D, device)
        if kind == "mamba":
            self.mamba = Mamba2(D, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                                ssm_state=cfg.ssm_state, dtype=cfg.dtype, device=device,
                                generator=generator)
        else:
            self.attn = Attention(D, cfg.n_heads, cfg.n_kv_heads, _head_dim(cfg), cfg.dtype,
                                  device, generator)
        self.ln2 = rmsnorm_init(D, device)
        self.moe = MoE(D, cfg.moe_d_ff, cfg.n_experts, cfg.dtype, cfg.shared_d_ff, device,
                       generator)


class GraniteHybrid(nn.Module):
    """``embed (Vpad, D)``, ``layers``, ``final_norm (D,)`` and, unless the
    embeddings are tied, ``head (D, Vpad)``. ``generator=None`` leaves the
    drawn weights uninitialised (they are about to be loaded)."""

    AXES = {"embed": ("vocab", "embed"), "final_norm": ("norm",), "head": ("embed", "vocab")}

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        vpad = pad_vocab(cfg.vocab_size)
        self.embed = embed_init(generator, vpad, cfg.d_model, cfg.dtype, device)
        self.layers = nn.ModuleList(HybridMoELayer(cfg, kind, device, generator)
                                    for kind, _ in _kinds(cfg))
        self.final_norm = rmsnorm_init(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(_init((cfg.d_model, vpad),
                                           1.0 / math.sqrt(cfg.d_model), cfg.dtype,
                                           device, generator))


def _embed(params, cfg, tokens):
    return shard_activation(embed_lookup(params.embed, tokens) * cfg.embedding_multiplier)


def _out(params, cfg, h):
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    return _logits(params, cfg, h) / cfg.logits_scaling


def _attn_kw(cfg) -> dict:
    return {"window": cfg.sliding_window, "rope": False, "scale": cfg.attn_scale or None}


def _moe(lp, h, cfg):
    """h (B, S, D) plus the layer's scaled MoE of its norm."""
    m, _ = moe_apply(lp.moe, rmsnorm(h, lp.ln2, cfg.norm_eps), n_top=cfg.n_experts_per_tok,
                     dropless=True)
    return h + cfg.residual_multiplier * m


def _layer(lp, h, cfg, positions):
    """One layer over a whole sequence, both residuals (the loss's body)."""
    u = rmsnorm(h, lp.ln1, cfg.norm_eps)
    if hasattr(lp, "mamba"):
        a, _ = mamba2_forward(lp.mamba, u, chunk=cfg.ssm_chunk, use_kernel=cfg.use_ssd_kernel,
                              gate_first=True)
    else:
        a = multihead_attn(lp.attn, u, positions, causal=True, use_flash=cfg.use_flash,
                           **_attn_kw(cfg))
    return _moe(lp, h + cfg.residual_multiplier * a, cfg)


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device).expand(B, S)


def granite_loss(params, cfg, batch):
    """Mean cross-entropy of the scaled logits against ``batch["targets"]``
    (-1 ignored); the dropless MoE adds no load-balancing term."""
    tokens = batch["tokens"]
    h, positions = _embed(params, cfg, tokens), _positions(tokens)
    for lp in params.layers:
        h = shard_activation(h)
        h = remat(cfg.remat, _layer, lp, h, cfg, positions)
    return softmax_xent(_out(params, cfg, h), batch["targets"], cfg.vocab_size)


def granite_init_state(cfg, batch, cache_len, device=None) -> HybridState:
    """Empty caches (zero conv windows and states, empty KV slots), pos 0;
    under a mesh laid out by their logical axes."""
    kinds = [k for k, _ in _kinds(cfg)]
    n_mamba, n_attn = kinds.count("mamba"), kinds.count("attention")
    m = MambaCache.init(batch, cfg.d_model, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                        ssm_state=cfg.ssm_state, dtype=cfg.dtype, device=device)
    m = MambaCache(*(t.expand(n_mamba, *t.shape).clone() for t in m))
    cap = cache_capacity(cache_len, cfg.sliding_window)
    a = KVCache.init(batch, cap, cfg.n_kv_heads, _head_dim(cfg), cfg.dtype, device)
    a = KVCache(*(t.expand(n_attn, *t.shape).clone() for t in a))
    return HybridState(place_state(m, MAMBA_CACHE_AXES), place_state(a, KV_CACHE_AXES), 0)


def granite_prefill(params, cfg, batch, cache_len):
    """Run the prompt. Returns (last logits, HybridState with ``pos`` the
    prompt's length): every Mamba2 layer's conv windows and final SSM state
    and every attention layer's K/V of the last ``cap`` positions (rolling
    for a window)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    h, positions = _embed(params, cfg, tokens), _positions(tokens)
    state = granite_init_state(cfg, B, cache_len, tokens.device)
    m, a = state.mamba, state.attn
    cap = a.k.shape[2]
    take = min(S, cap)
    slot0 = (S - take) % cap if cfg.sliding_window else 0
    slots = (torch.arange(take, device=tokens.device) + slot0) % cap
    for lp, (kind, j) in zip(params.layers, _kinds(cfg)):
        h = shard_activation(h)
        u = rmsnorm(h, lp.ln1, cfg.norm_eps)
        if kind == "mamba":
            out, last = mamba2_forward(lp.mamba, u, chunk=cfg.ssm_chunk,
                                       use_kernel=cfg.use_ssd_kernel, gate_first=True,
                                       windows=True)
            for stack, t in zip(m, last):
                assign(stack, (j,), t)
        else:
            out, (k, v) = multihead_attn(lp.attn, u, positions, causal=True,
                                         use_flash=cfg.use_flash, return_kv=True,
                                         **_attn_kw(cfg))
            assign(a.k, (j, slice(None), slots), k[:, S - take:])
            assign(a.v, (j, slice(None), slots), v[:, S - take:])
        h = _moe(lp, h + cfg.residual_multiplier * out, cfg)
    assign(a.slot_pos, (slice(None), slots),
           torch.arange(S - take, S, dtype=torch.int32, device=tokens.device))
    return _out(params, cfg, h[:, -1]), HybridState(m, a, S)


def _step(params, cfg, state: HybridState, tokens):
    """One decode step as issued op by op; ``state.pos`` an int or a (1,)
    device tensor (``_decode_attend``). The caches are updated in place."""
    h = _embed(params, cfg, tokens)                                  # (B, D)
    m, a, pos = state
    for lp, (kind, j) in zip(params.layers, _kinds(cfg)):
        u = rmsnorm(h, lp.ln1, cfg.norm_eps)
        if kind == "mamba":
            out, _ = mamba2_decode(lp.mamba, u, MambaCache(m.conv_x[j], m.conv_bc[j], m.h[j]),
                                   gate_first=True)
        else:
            out, _ = decode_attn(lp.attn, u, KVCache(a.k[j], a.v[j], a.slot_pos[j]), pos,
                                 **_attn_kw(cfg))
        h = _moe(lp, (h + cfg.residual_multiplier * out)[:, None], cfg)[:, 0]
    return _out(params, cfg, h), HybridState(m, a, pos + 1)


def _caches(state: HybridState) -> list:
    return [*state.mamba, *state.attn]


def _rebuild(bufs, pos) -> HybridState:
    return HybridState(MambaCache(*bufs[:3]), KVCache(*bufs[3:]), pos)


def granite_decode_step(params, cfg, state: HybridState, tokens):
    """tokens: (B,) int. One decode step. Returns (logits, new state). Off the
    card, or under a mesh, the caches are updated in place. On the card the
    step is replayed from a CUDA graph from a shape's second step
    (``replay.decode_step``), its position a (1,) device tensor that
    ``_decode_attend`` writes by."""
    return replay.decode_step(_step, _caches, _rebuild, params, cfg, state, tokens)
