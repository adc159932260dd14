"""Plain PyTorch version of the flash-attention kernel (GQA, causal /
bidirectional / sliding-window). Mirror of
``repro.kernels.flash_attention.ref``. Shapes: q (B,S,H,hd), k/v (B,S,KV,hd)."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """``scale`` multiplies q.k (default 1/sqrt(hd)): the kernels' wrapper
    zero-pads hd and passes the scale of the unpadded width."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k)
    scores = scores / math.sqrt(hd) if scale is None else scores * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = (kpos <= qpos) if causal else torch.ones((S, S), dtype=torch.bool,
                                                    device=q.device)
    if window:
        mask = mask & (kpos > qpos - window)
    scores = torch.where(mask[None, None, None], scores.float(), -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkh->bskgh", w, v).reshape(B, S, H, hd)


def _scores(q, k, causal, window, scale):
    """The scaled scores in fp32, (B, KV, G, S, T), -1e30 where masked, and
    the mask (S, T)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.float())
    scores = scores / math.sqrt(hd) if scale is None else scores * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = (kpos <= qpos) if causal else torch.ones((S, S), dtype=torch.bool,
                                                    device=q.device)
    if window:
        mask = mask & (kpos > qpos - window)
    return torch.where(mask, scores, -1e30), mask


def attention_lse_ref(q, k, *, causal=True, window=0, scale=None):
    """(B, H, S) fp32: each query row's log-sum-exp of its scaled, masked
    scores, the number the 16-bit kernel's forward hands its backward."""
    B, S, H, _ = q.shape
    scores, _ = _scores(q, k, causal, window, scale)
    return torch.logsumexp(scores, dim=-1).reshape(B, H, S)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=0, scale=None):
    """dq, dk, dv in fp32 from the forward's output ``o`` and row log-sum-exp
    ``lse`` (B, H, S), the algorithm the backward kernel runs: P from the
    scores and ``lse``, D = rowsum(dO * O), dS = P * (dO.V^T - D), then
    dq = scale dS.K, dk = scale dS^T.Q and dv = P^T.dO, each summed over
    the query heads of a KV head."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    scores, mask = _scores(q, k, causal, window, scale)
    p = torch.exp(scores - lse.float().reshape(B, KV, G, S, 1)) * mask
    dog = do.float().reshape(B, S, KV, G, hd)
    og = o.float().reshape(B, S, KV, G, hd)
    dv = torch.einsum("bkgst,bskgh->btkh", p, dog)
    dp = torch.einsum("bskgh,btkh->bkgst", dog, v.float())
    dsum = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]       # (B, KV, G, S, 1)
    ds = p * (dp - dsum)
    dq = scale * torch.einsum("bkgst,btkh->bskgh", ds, k.float()).reshape(B, S, H, hd)
    dk = scale * torch.einsum("bkgst,bskgh->btkh", ds, q.float().reshape(B, S, KV, G, hd))
    return dq, dk, dv
