"""Uniform model facade: init / loss / prefill / decode_step. Mirror of
``repro.models.model`` for the dense transformer families and the pure-SSM
family (mamba2); the hybrid (zamba2) family is not ported yet (ROADMAP
Queue 1, item 10).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from .layers import (_init, embed_init, embed_lookup, pad_vocab, remat, rmsnorm,
                     rmsnorm_init, softmax_xent)
from .mamba2 import Mamba2, MambaCache, mamba2_decode, mamba2_forward
from .transformer import (Transformer, transformer_decode_step,
                          transformer_init, transformer_loss, transformer_prefill)


# --------------------------------------------------------------------------
# Pure-SSM LM (mamba2-2.7b)
# --------------------------------------------------------------------------
class SSMLayer(Mamba2):
    """A Mamba2 mixer plus its pre-norm ``ln``, the reference's layer dict."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__(cfg.d_model, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                         ssm_state=cfg.ssm_state, dtype=cfg.dtype, device=device,
                         generator=generator)
        self.ln = rmsnorm_init(cfg.d_model, device)


class SSM(nn.Module):
    """``embed (Vpad, D)``, ``layers``, ``final_norm (D,)`` and, unless the
    embeddings are tied, ``head (D, Vpad)``. ``generator=None`` leaves the
    drawn weights uninitialised (they are about to be loaded)."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        vpad = pad_vocab(cfg.vocab_size)
        self.embed = embed_init(generator, vpad, cfg.d_model, cfg.dtype, device)
        self.layers = nn.ModuleList(
            SSMLayer(cfg, device, generator) for _ in range(cfg.n_layers))
        self.final_norm = rmsnorm_init(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(_init((cfg.d_model, vpad),
                                           1.0 / math.sqrt(cfg.d_model), cfg.dtype,
                                           device, generator))


def ssm_init(generator, cfg, device=None) -> SSM:
    return SSM(cfg, device, generator)


def _lm_logits(params, cfg, h):
    if cfg.tie_embeddings:
        return h @ params.embed.t()
    return h @ params.head


def _ssm_layer(lp, h, cfg):
    out, _ = mamba2_forward(lp, rmsnorm(h, lp.ln, cfg.norm_eps), chunk=cfg.ssm_chunk,
                            use_kernel=cfg.use_ssd_kernel)
    return h + out


def _ssm_backbone(params, cfg, h):
    """Every layer in turn; with ``cfg.remat`` each one is checkpointed."""
    for lp in params.layers:
        h = remat(cfg.remat, _ssm_layer, lp, h, cfg)
    return h


def ssm_loss(params, cfg, batch):
    h = _ssm_backbone(params, cfg, embed_lookup(params.embed, batch["tokens"]))
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    return softmax_xent(_lm_logits(params, cfg, h), batch["targets"], cfg.vocab_size)


class SSMState(NamedTuple):
    caches: MambaCache  # stacked (L, ...) tensors
    pos: int


def ssm_prefill(params, cfg, batch, cache_len):
    """Run the prompt. Returns (last logits, SSMState). The prompt length
    must be a multiple of ``cfg.ssm_chunk``.

    The reference's deliberate quirk, kept so that prefill-then-decode
    matches it: the conv caches start at zero, not at the prompt's last K-1
    conv inputs (the decode continues with a fresh conv window); only the
    SSM state ``h`` carries the prompt over."""
    h = embed_lookup(params.embed, batch["tokens"])
    L = cfg.n_layers
    base = MambaCache.init(h.shape[0], cfg.d_model, expand=cfg.ssm_expand,
                           headdim=cfg.ssm_headdim, ssm_state=cfg.ssm_state,
                           dtype=cfg.dtype, device=h.device)
    caches = MambaCache(*(t.new_zeros((L, *t.shape)) for t in base))
    for i, lp in enumerate(params.layers):
        out, h_last = mamba2_forward(lp, rmsnorm(h, lp.ln, cfg.norm_eps),
                                     chunk=cfg.ssm_chunk, use_kernel=cfg.use_ssd_kernel)
        h = h + out
        caches.h[i] = h_last     # into the stacked state: no second copy of it
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    logits = _lm_logits(params, cfg, h[:, -1])
    return logits, SSMState(caches, batch["tokens"].shape[1])


def ssm_decode_step(params, cfg, state: SSMState, tokens):
    """tokens: (B,) int. One decode step. Returns (logits, new state); the
    caches are updated in place."""
    h = embed_lookup(params.embed, tokens)
    c = state.caches
    for i, lp in enumerate(params.layers):
        out, _ = mamba2_decode(lp, rmsnorm(h, lp.ln, cfg.norm_eps),
                               MambaCache(c.conv_x[i], c.conv_bc[i], c.h[i]))
        h = h + out
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    return _lm_logits(params, cfg, h), SSMState(c, state.pos + 1)


# --------------------------------------------------------------------------
# Facade
# --------------------------------------------------------------------------
class Model:
    def __init__(self, cfg):
        self.cfg = cfg

    def _check_ported(self):
        if self.cfg.family == "hybrid":
            raise NotImplementedError("family 'hybrid' is not ported yet "
                                      "(ROADMAP Queue 1, item 10)")

    def init(self, seed: int = 0, device=None) -> Transformer | SSM:
        """Weights drawn from ``torch.Generator(device).manual_seed(seed)``
        (not the JAX init's numbers: ``repro_torch.convert`` brings those)."""
        self._check_ported()
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        if self.cfg.family == "ssm":
            return ssm_init(gen, self.cfg, device)
        return transformer_init(gen, self.cfg, device)

    def loss(self, params, batch):
        """The training loss, differentiable in ``params``' tensors."""
        self._check_ported()
        if self.cfg.family == "ssm":
            return ssm_loss(params, self.cfg, batch)
        return transformer_loss(params, self.cfg, batch)

    @torch.no_grad()
    def prefill(self, params, batch, cache_len):
        self._check_ported()
        if self.cfg.family == "ssm":
            return ssm_prefill(params, self.cfg, batch, cache_len)
        return transformer_prefill(params, self.cfg, batch, cache_len)

    @torch.no_grad()
    def decode_step(self, params, state, tokens):
        self._check_ported()
        if self.cfg.family == "ssm":
            return ssm_decode_step(params, self.cfg, state, tokens)
        return transformer_decode_step(params, self.cfg, state, tokens)
