"""GQA/MQA attention with RoPE, causal / bidirectional / sliding-window
masks, full-sequence forward (prefill) and single-token decode against a
(optionally rolling) KV cache. Mirror of ``repro.models.attention``.

The full-sequence path takes the same three routes in the same order as
the reference: the flash-attention kernel when ``use_flash``, the
query-chunked path for long sequences, else the dense path. The model paths
mask with -1e9; the kernel and its plain version mask with -1e30.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..kernels.flash_attention import ops as flash_ops
from .layers import _init, apply_rope


class Attention(nn.Module):
    """``q (D,H,hd)``, ``k``/``v`` ``(D,KV,hd)``, ``o (H,hd,D_out)``; the
    output width ``d_out`` is the input width ``D`` unless given (zamba2's
    shared block reads ``2·D`` and writes ``D``)."""

    def __init__(self, d_model, n_heads, n_kv, head_dim, dtype, device=None,
                 generator=None, d_out=None):
        super().__init__()
        s = 1.0 / math.sqrt(d_model)
        so = 1.0 / math.sqrt(n_heads * head_dim)
        d_out = d_out or d_model
        self.q = nn.Parameter(_init((d_model, n_heads, head_dim), s, dtype, device, generator))
        self.k = nn.Parameter(_init((d_model, n_kv, head_dim), s, dtype, device, generator))
        self.v = nn.Parameter(_init((d_model, n_kv, head_dim), s, dtype, device, generator))
        self.o = nn.Parameter(_init((n_heads, head_dim, d_out), so, dtype, device, generator))


def attn_init(generator, d_model, n_heads, n_kv, head_dim, dtype,
              device=None) -> Attention:
    return Attention(d_model, n_heads, n_kv, head_dim, dtype, device, generator)


def _project(x, w):
    """x (..., D) @ w (D, N, hd) -> (..., N, hd), contiguous."""
    D, N, hd = w.shape
    return (x @ w.reshape(D, N * hd)).reshape(*x.shape[:-1], N, hd)


def _mask(q_pos, k_pos, causal: bool, window: int):
    """(..., Sq, Sk) boolean mask. window=0 -> unbounded."""
    if causal:
        m = k_pos[..., None, :] <= q_pos[..., :, None]
    else:
        m = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], k_pos.shape[-1]),
                       dtype=torch.bool, device=q_pos.device)
    if window:
        m = m & (k_pos[..., None, :] > q_pos[..., :, None] - window)
    return m


def _attend(qg, k, v, mask, dtype):
    """qg (B,Sq,KV,G,hd), k/v (B,Sk,KV,hd), mask (B,Sq,Sk) -> (B,Sq,KV,G,hd)."""
    hd = k.shape[-1]
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k) / math.sqrt(hd)
    scores = torch.where(mask[:, None, None], scores.float(), -1e9)
    w = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bkgst,btkh->bskgh", w, v)


def _dense_attn(q, k, v, positions, causal, window):
    """Materialises the full (S, S) score matrix — short sequences only."""
    B, S, KV, hd = k.shape
    H = q.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    mask = _mask(positions, positions, causal, window)      # (B, S, S)
    return _attend(qg, k, v, mask, q.dtype).reshape(B, S, H, hd)


def _chunked_attn(q, k, v, positions, causal, window, chunk_q):
    """Loop over query chunks: peak score temp is (B,KV,G,Qc,S) instead of
    (B,KV,G,S,S)."""
    B, S, KV, hd = k.shape
    H = q.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    outs = []
    for c0 in range(0, S, chunk_q):
        pc = positions[:, c0:c0 + chunk_q]
        mask = _mask(pc, positions, causal, window)         # (B, Qc, S)
        outs.append(_attend(qg[:, c0:c0 + chunk_q], k, v, mask, q.dtype))
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


def multihead_attn(p, x, positions, *, causal=True, window=0, rope_theta=1e4,
                   use_flash=False, flash_block=512, chunk_q_threshold=8192,
                   chunk_q=1024, return_kv=False):
    """x: (B, S, D) -> (B, S, D_out), ``D_out = p.o.shape[-1]``; with
    ``return_kv`` also the roped K and the V of this call, (B, S, KV, hd)
    each, for the prefill cache fill."""
    B, S, _ = x.shape
    q = apply_rope(_project(x, p.q), positions, rope_theta)
    k = apply_rope(_project(x, p.k), positions, rope_theta)
    v = _project(x, p.v)
    if use_flash:
        o = flash_ops.flash_attention(q, k, v, causal, window,
                                      flash_block, flash_block)
    elif S >= chunk_q_threshold and S % chunk_q == 0:
        o = _chunked_attn(q, k, v, positions, causal, window, chunk_q)
    else:
        o = _dense_attn(q, k, v, positions, causal, window)
    H, hd, D_out = p.o.shape
    out = o.reshape(B, S, H * hd) @ p.o.reshape(H * hd, D_out)
    return (out, (k, v)) if return_kv else out


# --------------------------------------------------------------------------
# Decode with (rolling) KV cache
# --------------------------------------------------------------------------
class KVCache(NamedTuple):
    k: torch.Tensor          # (B, C, KV, hd)
    v: torch.Tensor          # (B, C, KV, hd)
    slot_pos: torch.Tensor   # (C,) int32, position stored in each slot (-1 empty)

    @staticmethod
    def init(batch, capacity, n_kv, head_dim, dtype, device=None):
        return KVCache(
            k=torch.zeros((batch, capacity, n_kv, head_dim), dtype=dtype, device=device),
            v=torch.zeros((batch, capacity, n_kv, head_dim), dtype=dtype, device=device),
            slot_pos=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        )


def cache_capacity(seq_len: int, window: int) -> int:
    return min(seq_len, window) if window else seq_len


def decode_attn(p, x, cache: KVCache, pos: int, *, window=0, rope_theta=1e4):
    """x: (B, D) one new token at position ``pos``. Returns (out (B, D_out),
    cache), ``D_out = p.o.shape[-1]``. Rolling write when window is set.

    The cache is updated in place (the reference returns a new one): this
    saves a copy of the whole cache per layer and step. With no window and
    ``pos >= C`` the reference's ``dynamic_update_slice`` clamps the K/V
    write to slot ``C-1`` while its ``slot_pos`` scatter drops the write;
    both are kept here."""
    B = x.shape[0]
    H, hd = p.q.shape[1], p.q.shape[2]
    KV = p.k.shape[1]
    C = cache.k.shape[1]
    pos_b = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(_project(x, p.q)[:, None], pos_b, rope_theta)[:, 0]
    k = apply_rope(_project(x, p.k)[:, None], pos_b, rope_theta)[:, 0]
    v = _project(x, p.v)
    slot = pos % max(C, 1) if window else pos
    kv_slot = min(max(slot, 0), C - 1)
    cache.k[:, kv_slot] = k
    cache.v[:, kv_slot] = v
    if 0 <= slot < C:
        cache.slot_pos[slot] = pos
    npos = cache.slot_pos
    qg = q.reshape(B, KV, H // KV, hd)
    scores = torch.einsum("bkgh,bckh->bkgc", qg, cache.k) / math.sqrt(hd)
    valid = (npos >= 0) & (npos <= pos)
    if window:
        valid = valid & (npos > pos - window)
    scores = torch.where(valid[None, None, None, :], scores.float(), -1e9)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    o = torch.einsum("bkgc,bckh->bkgh", w, cache.v).reshape(B, H * hd)
    return o @ p.o.reshape(H * hd, p.o.shape[-1]), cache
