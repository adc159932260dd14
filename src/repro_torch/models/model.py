"""Uniform model facade: init / prefill / decode_step. Mirror of
``repro.models.model`` for the dense transformer families; the SSM
(mamba2) and hybrid (zamba2) families are not ported yet (ROADMAP Queue 1,
items 9 and 10).
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .transformer import (Transformer, transformer_decode_step,
                          transformer_init, transformer_prefill)


class Model:
    def __init__(self, cfg):
        self.cfg = cfg

    def _dense_only(self):
        f = self.cfg.family
        if f in ("ssm", "hybrid"):
            item = 9 if f == "ssm" else 10
            raise NotImplementedError(f"family {f!r} is not ported yet "
                                      f"(ROADMAP Queue 1, item {item})")

    def init(self, seed: int = 0, device=None) -> Transformer:
        """Weights drawn from ``torch.Generator(device).manual_seed(seed)``
        (not the JAX init's numbers: ``repro_torch.convert`` brings those)."""
        self._dense_only()
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return transformer_init(gen, self.cfg, device)

    @torch.no_grad()
    def prefill(self, params, batch, cache_len):
        self._dense_only()
        return transformer_prefill(params, self.cfg, batch, cache_len)

    @torch.no_grad()
    def decode_step(self, params, state, tokens):
        self._dense_only()
        return transformer_decode_step(params, self.cfg, state, tokens)
