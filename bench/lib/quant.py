"""Matrix products of the references, exact or in a lower number format.

The lower-precision control puts the reference in the program's place with
both operands of every matrix product rounded to ``float8_e4m3fn`` (one
scale a tensor, its largest magnitude at 448), the step below the bf16 the
configurations state; the products themselves run in float32. The
gradient passes the rounding straight through."""
from __future__ import annotations

import torch

FP8_MAX = 448.0


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(dtype).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def rounded(x, quant):
    """``x`` rounded to the format ``quant`` ("fp8" or None: unchanged)."""
    if quant is None:
        return x
    if quant != "fp8":
        raise ValueError(f"unknown number format {quant!r}")
    return _Round.apply(x, torch.float8_e4m3fn)


def qmm(x, w, quant=None):
    """``x @ w`` in float32, each operand first rounded to ``quant``."""
    return rounded(x, quant) @ rounded(w, quant)
