"""Uniform model facade: init / loss / prefill / decode_step / encode.
Mirror of ``repro.models.model`` for the transformer families (dense, MoE,
encoder, VLM), the pure-SSM family (mamba2) and the hybrid family (zamba2);
beside them the port-only ``moe_hybrid`` family (granite-4.0-h-small,
``granite_hybrid.py``).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from ..distributed import shard_activation
from ..distributed.sharding import assign, place_state
from ..spans import span
from .attention import KV_CACHE_AXES
from .granite_hybrid import (GraniteHybrid, granite_decode_step, granite_init_state,
                             granite_loss, granite_prefill)
from .layers import (_init, embed_init, embed_lookup, pad_vocab, remat, rmsnorm,
                     rmsnorm_init, softmax_xent)
from .mamba2 import (MAMBA_CACHE_AXES, MambaCache, SSMLayer, mamba2_decode, mamba2_forward,
                     ssm_layer)
from . import replay
from .transformer import (DecodeState, Transformer, _embed_inputs, _logits, _scan_layers,
                          init_cache, transformer_decode_step, transformer_loss,
                          transformer_prefill)
from .zamba2 import HybridState, Zamba2, zamba2_decode_step, zamba2_forward, zamba2_init_state


# --------------------------------------------------------------------------
# Pure-SSM LM (mamba2-2.7b)
# --------------------------------------------------------------------------
class SSM(nn.Module):
    """``embed (Vpad, D)``, ``layers``, ``final_norm (D,)`` and, unless the
    embeddings are tied, ``head (D, Vpad)``. ``generator=None`` leaves the
    drawn weights uninitialised (they are about to be loaded)."""

    AXES = {"embed": ("vocab", "embed"), "final_norm": ("norm",), "head": ("embed", "vocab")}

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


def _ssm_backbone(params, cfg, h):
    """Every layer in turn; with ``cfg.remat`` each one is checkpointed."""
    for lp in params.layers:
        h = shard_activation(h)
        h = remat(cfg.remat, ssm_layer, lp, h, cfg)
    return h


def ssm_loss(params, cfg, batch):
    h = shard_activation(embed_lookup(params.embed, batch["tokens"]))
    h = _ssm_backbone(params, cfg, h)
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    return softmax_xent(_logits(params, cfg, h), batch["targets"], cfg.vocab_size)


class SSMState(NamedTuple):
    caches: MambaCache  # stacked (L, ...) tensors
    pos: int


def ssm_init_caches(cfg, batch, device=None) -> MambaCache:
    """Zero stacked caches; under a mesh laid out by ``MAMBA_CACHE_AXES``."""
    base = MambaCache.init(batch, cfg.d_model, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                           ssm_state=cfg.ssm_state, dtype=cfg.dtype, device=device)
    return place_state(MambaCache(*(t.new_zeros((cfg.n_layers, *t.shape)) for t in base)),
                       MAMBA_CACHE_AXES)


def ssm_prefill(params, cfg, batch, cache_len):
    """Run the prompt. Returns (last logits, SSMState). The prompt length
    must be a multiple of ``cfg.ssm_chunk``.

    The reference's deliberate quirk, kept so that prefill-then-decode
    matches it: the conv caches start at zero, not at the prompt's last K-1
    conv inputs (the decode continues with a fresh conv window); only the
    SSM state ``h`` carries the prompt over."""
    h = shard_activation(embed_lookup(params.embed, batch["tokens"]))
    caches = ssm_init_caches(cfg, h.shape[0], h.device)
    for i, lp in enumerate(params.layers):
        h = shard_activation(h)
        out, h_last = mamba2_forward(lp, rmsnorm(h, lp.ln, cfg.norm_eps),
                                     chunk=cfg.ssm_chunk, use_kernel=cfg.use_ssd_kernel)
        h = h + out
        assign(caches.h, (i,), h_last)  # into the stacked state: no second copy of it
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    logits = _logits(params, cfg, h[:, -1])
    return logits, SSMState(caches, batch["tokens"].shape[1])


def _ssm_issued_step(params, cfg, state: SSMState, tokens):
    """One decode step as issued op by op; the caches are updated in place,
    and ``state.pos`` is only counted on."""
    h = shard_activation(embed_lookup(params.embed, tokens))
    c = state.caches
    for i, lp in enumerate(params.layers):
        out, _ = mamba2_decode(lp, rmsnorm(h, lp.ln, cfg.norm_eps),
                               MambaCache(c.conv_x[i], c.conv_bc[i], c.h[i]))
        h = h + out
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    return _logits(params, cfg, h), SSMState(c, state.pos + 1)


def _ssm_rebuild(bufs, pos) -> SSMState:
    return SSMState(MambaCache(*bufs), pos)


def ssm_decode_step(params, cfg, state: SSMState, tokens):
    """tokens: (B,) int. One decode step. Returns (logits, new state). Off the
    card, or under a mesh, the caches are updated in place. On the card the
    step is replayed from a CUDA graph from a shape's second step
    (``replay.decode_step``)."""
    return replay.decode_step(_ssm_issued_step, lambda s: s.caches, _ssm_rebuild, params, cfg,
                              state, tokens)


# --------------------------------------------------------------------------
# Hybrid (zamba2)
# --------------------------------------------------------------------------
def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device).expand(B, S)


def hybrid_loss(params, cfg, batch):
    tokens = batch["tokens"]
    h = shard_activation(embed_lookup(params.embed, tokens))
    h = zamba2_forward(params, cfg, h, _positions(tokens))
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    return softmax_xent(_logits(params, cfg, h), batch["targets"], cfg.vocab_size)


def hybrid_prefill(params, cfg, batch, cache_len):
    """Run the prompt. Returns (last logits, HybridState). The prompt length
    must be a multiple of ``cfg.ssm_chunk``.

    The reference's quirk, kept so that prefill-then-decode matches it: the
    state returned is a fresh, empty one with ``pos = 0``
    (``zamba2_init_state``), so the decode steps after it do not see the
    prompt."""
    tokens = batch["tokens"]
    h = shard_activation(embed_lookup(params.embed, tokens))
    h = zamba2_forward(params, cfg, h, _positions(tokens))
    h = rmsnorm(h[:, -1], params.final_norm, cfg.norm_eps)
    state = zamba2_init_state(cfg, tokens.shape[0], cache_len, cfg.dtype, tokens.device)
    return _logits(params, cfg, h), state


def hybrid_decode_step(params, cfg, state: HybridState, tokens):
    """tokens: (B,) int. One decode step. Returns (logits, new state); the
    caches are updated in place."""
    h = shard_activation(embed_lookup(params.embed, tokens))
    h, state = zamba2_decode_step(params, cfg, state, h)
    h = rmsnorm(h, params.final_norm, cfg.norm_eps)
    return _logits(params, cfg, h), state


# --------------------------------------------------------------------------
# Facade
# --------------------------------------------------------------------------
class Family(NamedTuple):
    """What ``Model`` calls for one family."""
    cls: type[nn.Module]        # holds the parameters: cls(cfg, device, generator)
    loss: Callable              # (params, cfg, batch) -> loss
    prefill: Callable           # (params, cfg, batch, cache_len) -> (logits, state)
    decode_step: Callable       # (params, cfg, state, tokens) -> (logits, state)
    state_axes: tuple           # the decode state's logical axes, ``pos`` ()
    init_state: Callable        # (cfg, batch, cache_len, device) -> empty decode state


#: dense, MoE, encoder and VLM
TRANSFORMER = Family(Transformer, transformer_loss, transformer_prefill, transformer_decode_step,
                     DecodeState(KV_CACHE_AXES, ()),
                     lambda cfg, b, n, dev: DecodeState(init_cache(cfg, b, n, cfg.dtype, dev), n))
FAMILIES = {
    "ssm": Family(SSM, ssm_loss, ssm_prefill, ssm_decode_step, SSMState(MAMBA_CACHE_AXES, ()),
                  lambda cfg, b, n, dev: SSMState(ssm_init_caches(cfg, b, dev), n)),
    "hybrid": Family(Zamba2, hybrid_loss, hybrid_prefill, hybrid_decode_step,
                     HybridState(MAMBA_CACHE_AXES, KV_CACHE_AXES, ()),
                     lambda cfg, b, n, dev: zamba2_init_state(cfg, b, n, cfg.dtype, dev)._replace(pos=n)),
    "moe_hybrid": Family(GraniteHybrid, granite_loss, granite_prefill, granite_decode_step,
                         HybridState(MAMBA_CACHE_AXES, KV_CACHE_AXES, ()),
                         lambda cfg, b, n, dev: granite_init_state(cfg, b, n, dev)._replace(pos=n)),
}


def family(cfg) -> Family:
    """``cfg.family``'s record: its own, or the transformer's."""
    return FAMILIES.get(cfg.family, TRANSFORMER)


def model_class(cfg) -> type[nn.Module]:
    """The module class that holds ``cfg.family``'s parameters."""
    return family(cfg).cls


#: the model's attributes that hold one module per layer
STACKED = ("layers", "mamba_layers")


class Model:
    def __init__(self, cfg):
        self.cfg = cfg
        self.family = family(cfg)

    def init(self, seed: int = 0, device=None) -> Transformer | SSM | Zamba2 | GraniteHybrid:
        """Weights drawn from ``torch.Generator(device).manual_seed(seed)``
        (not the JAX init's numbers: ``repro_torch.convert`` brings those)."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return self.family.cls(self.cfg, device, gen)

    @staticmethod
    def logical_axes(params: nn.Module) -> dict[str, tuple]:
        """``{parameter name: logical axes}`` of any module of the port, for
        ``distributed.shard_params``: the reference's twin ``axes`` tree
        keyed by the port's names. Each module class declares its own
        parameters' axes (``AXES``); a layer's tensor has its stacked
        leaf's axes, which start with ``"layers"``."""
        out = {}
        for mod_name, mod in params.named_modules():
            for attr, _ in mod.named_parameters(recurse=False):
                name = f"{mod_name}.{attr}" if mod_name else attr
                axes = type(mod).AXES[attr]
                out[name] = ("layers", *axes) if name.split(".")[0] in STACKED else axes
        return out

    def loss(self, params, batch):
        """The training loss, differentiable in ``params``' tensors."""
        return self.family.loss(params, self.cfg, batch)

    @torch.no_grad()
    def prefill(self, params, batch, cache_len):
        return self.family.prefill(params, self.cfg, batch, cache_len)

    @torch.no_grad()
    @span("model.decode")
    def decode_step(self, params, state, tokens):
        return self.family.decode_step(params, self.cfg, state, tokens)

    def decode_state_axes(self):
        """The logical axes of ``init_decode_state``'s tensors, a tree of the
        same structure (``pos`` is ``()``)."""
        return self.family.state_axes

    def init_decode_state(self, batch, cache_len, device=None):
        """The empty decode state of ``batch`` sequences, its caches sized for
        ``cache_len`` and ``pos = cache_len``, as the reference builds it
        for the dry-run; under a mesh laid out by ``decode_state_axes``."""
        return self.family.init_state(self.cfg, batch, cache_len, resolve_device(device))

    @torch.no_grad()
    def encode(self, params, batch):
        """Encoder-only forward: logits over the whole sequence (hubert)."""
        cfg = self.cfg
        h = _embed_inputs(params, cfg, batch)
        B, S, _ = h.shape
        positions = torch.arange(S, device=h.device).expand(B, S)
        h, _ = _scan_layers(params, cfg, h, positions)
        h = rmsnorm(h, params.final_norm, cfg.norm_eps)
        return _logits(params, cfg, h)
