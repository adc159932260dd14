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
