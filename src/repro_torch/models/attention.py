"""GQA/MQA attention with RoPE, causal / bidirectional / sliding-window
masks, full-sequence forward (prefill) and single-token decode against a
(optionally rolling) KV cache. Mirror of ``repro.models.attention``.

The full-sequence path takes the same three routes in the same order as
the reference: the flash-attention kernel when ``use_flash``, the
query-chunked path for long sequences, else the dense path. The model paths
mask with -1e9; the kernel and its plain version mask with -1e30.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..distributed.sharding import (attention_specs, entry_axes, kv_heads_of_rank, linear,
                                    shard_map, spec_of)
from ..kernels.flash_attention import ops as flash_ops
from .layers import _init, apply_rope


class Attention(nn.Module):
    """``q (D,H,hd)``, ``k``/``v`` ``(D,KV,hd)``, ``o (H,hd,D_out)``; the
    output width ``d_out`` is the input width ``D`` unless given (zamba2's
    shared block reads ``2·D`` and writes ``D``)."""

    AXES = {"q": ("embed", "heads", "head_dim"), "k": ("embed", "kv_heads", "head_dim"),
            "v": ("embed", "kv_heads", "head_dim"), "o": ("heads", "head_dim", "embed")}

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
    return linear(x, w)


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


def _scaled(scores, hd, scale):
    """q.k times ``scale``, or over sqrt(hd) when it is None."""
    return scores / math.sqrt(hd) if scale is None else scores * scale


def _attend(qg, k, v, mask, dtype, scale=None):
    """qg (B,Sq,KV,G,hd), k/v (B,Sk,KV,hd), mask (B,Sq,Sk) -> (B,Sq,KV,G,hd)."""
    scores = _scaled(torch.einsum("bskgh,btkh->bkgst", qg, k), k.shape[-1], scale)
    scores = torch.where(mask[:, None, None], scores.float(), -1e9)
    w = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bkgst,btkh->bskgh", w, v)


def _dense_attn(q, k, v, positions, causal, window, scale=None):
    """Materialises the full (S, S) score matrix — short sequences only."""
    B, S, KV, hd = k.shape
    H = q.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    mask = _mask(positions, positions, causal, window)      # (B, S, S)
    return _attend(qg, k, v, mask, q.dtype, scale).reshape(B, S, H, hd)


def _chunked_attn(q, k, v, positions, causal, window, chunk_q, scale=None):
    """Loop over query chunks: peak score temp is (B,KV,G,Qc,S) instead of
    (B,KV,G,S,S)."""
    B, S, KV, hd = k.shape
    H = q.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    outs = []
    for c0 in range(0, S, chunk_q):
        pc = positions[:, c0:c0 + chunk_q]
        mask = _mask(pc, positions, causal, window)         # (B, Qc, S)
        outs.append(_attend(qg[:, c0:c0 + chunk_q], k, v, mask, q.dtype, scale))
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


def multihead_attn(p, x, positions, *, causal=True, window=0, rope_theta=1e4,
                   use_flash=False, chunk_q_threshold=8192, chunk_q=1024, return_kv=False,
                   rope=True, scale=None):
    """x: (B, S, D) -> (B, S, D_out), ``D_out = p.o.shape[-1]``; with
    ``return_kv`` also the roped K and the V of this call, (B, S, KV, hd)
    each, for the prefill cache fill. ``rope=False``: no position embedding
    (NoPE); ``scale`` multiplies q.k (None: 1/sqrt(hd))."""
    B, S, _ = x.shape
    q, k = _project(x, p.q), _project(x, p.k)
    if rope:
        q, k = apply_rope(q, positions, rope_theta), apply_rope(k, positions, rope_theta)
    v = _project(x, p.v)

    def attend(q, k, v, positions):
        if use_flash:
            return flash_ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                             causal, window, scale)
        if S >= chunk_q_threshold and S % chunk_q == 0:
            return _chunked_attn(q, k, v, positions, causal, window, chunk_q, scale)
        return _dense_attn(q, k, v, positions, causal, window, scale)

    if isinstance(q, DTensor):
        # under a mesh: on each rank's batch and heads, as XLA partitions the
        # reference; the kernel needs local tensors
        mesh = q.device_mesh
        sq, skv = attention_specs(q.shape, k.shape, mesh)
        heads = kv_heads_of_rank(sq[2], skv[2], q.shape[2], k.shape[2], mesh)
        local, grads = attend, None
        if heads != slice(None):
            # K and V whole, each rank's part of their gradient its heads'
            def local(q, k, v, positions, whole=attend):
                return whole(q, k[:, :, heads], v[:, :, heads], positions)
            grads = [(), entry_axes(sq[2]), entry_axes(sq[2]), ()]
        attend = shard_map(local, mesh, (sq, skv, skv, sq[:1]), sq, partial_grads=grads)
    out = linear(attend(q, k, v, positions), p.o, 2)
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


#: the logical axes of a stack of caches (L, ...), the reference's
#: ``decode_state_axes`` leaves
KV_CACHE_AXES = KVCache(k=("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                        v=("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                        slot_pos=("layers", "kv_seq"))


def cache_capacity(seq_len: int, window: int) -> int:
    return min(seq_len, window) if window else seq_len


def _decode_attend(q, k, v, ck, cv, slot_pos, pos, window: int, heads=slice(None),
                   scale=None):
    """q (B,H,hd), k/v (B,KV,hd) of the token at ``pos``: k and v written
    into the caches ``ck``/``cv`` (B,C,KV,hd) and ``slot_pos`` (C,) in place,
    then q attends over the KV heads ``heads`` of them. Returns (B, H, hd).
    ``pos`` is an int, or a (1,) int64 tensor on the device that no host
    code reads (a step a CUDA graph replays): the same writes, by index."""
    B, H, hd = q.shape
    C = ck.shape[1]
    slot = pos % max(C, 1) if window else pos
    if isinstance(pos, torch.Tensor):
        kv_slot = slot.clamp(0, C - 1)
        ck.index_copy_(1, kv_slot, k[:, None])
        cv.index_copy_(1, kv_slot, v[:, None])
        slot_pos.index_copy_(0, kv_slot, torch.where(slot < C, pos, slot_pos[kv_slot])
                             .to(slot_pos.dtype))
    else:
        kv_slot = min(max(slot, 0), C - 1)
        ck[:, kv_slot] = k
        cv[:, kv_slot] = v
        if 0 <= slot < C:
            slot_pos[slot:slot + 1].fill_(pos)  # a fill on the device, no copy from the host
    ck, cv = ck[:, :, heads], cv[:, :, heads]
    KV = ck.shape[2]
    qg = q.reshape(B, KV, H // KV, hd)
    scores = _scaled(torch.einsum("bkgh,bckh->bkgc", qg, ck), hd, scale)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        valid = valid & (slot_pos > pos - window)
    scores = torch.where(valid[None, None, None, :], scores.float(), -1e9)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgc,bckh->bkgh", w, cv).reshape(B, H, hd)


def decode_attn(p, x, cache: KVCache, pos, *, window=0, rope_theta=1e4, rope=True,
                scale=None):
    """x: (B, D) one new token at position ``pos`` (with no ``rope``, an int
    or a device tensor as ``_decode_attend`` takes). Returns (out (B, D_out),
    cache), ``D_out = p.o.shape[-1]``. Rolling write when window is set;
    ``rope`` and ``scale`` as in ``multihead_attn``.

    The cache is updated in place (the reference returns a new one): this
    saves a copy of the whole cache per layer and step. With no window and
    ``pos >= C`` the reference's ``dynamic_update_slice`` clamps the K/V
    write to slot ``C-1`` while its ``slot_pos`` scatter drops the write;
    both are kept here.

    Under a mesh the writes and the attention run on each rank's shards of
    the cache, as it is laid out (``decode_state_axes``): its batch and,
    where the KV heads are split, whole GQA groups of query heads; where
    they are whole, a rank's query heads may still split and read their own
    KV heads (``attention_specs``)."""
    B = x.shape[0]
    q, k = _project(x, p.q), _project(x, p.k)
    if rope:
        pos_b = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q[:, None], pos_b, rope_theta)[:, 0]
        k = apply_rope(k[:, None], pos_b, rope_theta)[:, 0]
    v = _project(x, p.v)

    attend = functools.partial(_decode_attend, pos=pos, window=window, scale=scale)
    if any(isinstance(t, DTensor) for t in (q, *cache)):
        mesh = next(t.device_mesh for t in (q, *cache) if isinstance(t, DTensor))
        bax, _, hax, _ = spec_of(cache.k)
        H, hd = q.shape[1:]
        sq, skv = attention_specs((B, 1, H, hd), cache.k.shape, mesh)
        qh = sq[2] if skv[2] == hax else hax
        attend = shard_map(
            functools.partial(attend, heads=kv_heads_of_rank(qh, hax, H, cache.k.shape[2], mesh)),
            mesh, ((bax, qh), (bax, hax), (bax, hax), spec_of(cache.k), spec_of(cache.v),
                   spec_of(cache.slot_pos)), (bax, qh))
    return linear(attend(q, k, v, *cache), p.o, 2), cache
