"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) block in PyTorch.
Mirror of ``repro.models.mamba2``.

Chunked SSD forward (prefill): intra-chunk quadratic term plus the
inter-chunk first-order recurrence over chunk states (a loop over chunks,
or the CUDA kernel in ``kernels/ssd_scan`` with ``use_kernel``).
Single-token recurrent decode against a (conv window, SSM state) cache.

x/z/B/C/dt are separate projections, as in the reference. Parameters keep
the reference's names and shapes, so a JAX param tree converts by a rename
(``repro_torch.convert``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import _init, rmsnorm, rmsnorm_init


class Mamba2(nn.Module):
    """One Mamba2 mixer. ``A_log``, ``D``, ``dt_bias`` and ``norm_w`` stay
    fp32 in a bf16 model and keep the reference's constant inits
    (A = -exp(0) = -1, D = 1, softplus(-2) ~ 0.13, norm 1).
    ``generator=None`` leaves the drawn weights uninitialised (they are
    about to be loaded)."""

    def __init__(self, d_model, *, expand=2, headdim=64, ssm_state=128,
                 conv_dim=4, dtype=torch.bfloat16, device=None, generator=None):
        super().__init__()
        d_inner = expand * d_model
        H = d_inner // headdim
        N = ssm_state
        s = 1.0 / math.sqrt(d_model)

        def drawn(shape, scale):
            return nn.Parameter(_init(shape, scale, dtype, device, generator))

        def const(shape, value, dt):
            return nn.Parameter(torch.full(shape, value, dtype=dt, device=device))

        self.in_x = drawn((d_model, d_inner), s)
        self.in_z = drawn((d_model, d_inner), s)
        self.in_bc = drawn((d_model, 2 * N), s)
        self.in_dt = drawn((d_model, H), s)
        self.conv_x = drawn((conv_dim, d_inner), 0.5)
        self.conv_x_b = const((d_inner,), 0.0, dtype)
        self.conv_bc = drawn((conv_dim, 2 * N), 0.5)
        self.conv_bc_b = const((2 * N,), 0.0, dtype)
        self.A_log = const((H,), 0.0, torch.float32)
        self.D = const((H,), 1.0, torch.float32)
        self.dt_bias = const((H,), -2.0, torch.float32)
        self.norm_w = const((d_inner,), 1.0, torch.float32)
        self.out_proj = drawn((d_inner, d_model), 1.0 / math.sqrt(d_inner))


class SSMLayer(Mamba2):
    """A Mamba2 mixer plus its pre-norm ``ln``: one layer of the SSM family
    and of zamba2's backbone, the reference's layer dict."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__(cfg.d_model, expand=cfg.ssm_expand, headdim=cfg.ssm_headdim,
                         ssm_state=cfg.ssm_state, dtype=cfg.dtype, device=device,
                         generator=generator)
        self.ln = rmsnorm_init(cfg.d_model, device)


def mamba2_init(generator, d_model, *, expand=2, headdim=64, ssm_state=128,
                conv_dim=4, dtype=torch.bfloat16, device=None) -> Mamba2:
    return Mamba2(d_model, expand=expand, headdim=headdim, ssm_state=ssm_state,
                  conv_dim=conv_dim, dtype=dtype, device=device, generator=generator)


def _causal_conv(x, w, b):
    """Depthwise causal conv, window K. x: (B, S, C); w: (K, C)."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return F.silu(out + b)


def ssd_chunked(x, dt, B, C, A_log, D, chunk: int, use_kernel: bool = False):
    """SSD scan. x: (b, S, H, P); dt: (b, S, H); B, C: (b, S, N).
    Returns y: (b, S, H, P) and final state (b, H, N, P). S must be a
    multiple of ``chunk``, as in the reference."""
    b, S, H, Pd = x.shape
    N = B.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_chunked: sequence length {S} is not a multiple "
                         f"of the chunk {chunk}")
    nc = S // chunk
    A = -torch.exp(A_log)                                   # (H,)
    dt32 = dt.float()
    la = (dt32 * A).reshape(b, nc, chunk, H)                # log decay / step
    xr = x.reshape(b, nc, chunk, H, Pd)
    Br = B.reshape(b, nc, chunk, N).float()
    Cr = C.reshape(b, nc, chunk, N).float()
    dtr = dt32.reshape(b, nc, chunk, H)

    if use_kernel:
        from ..kernels.ssd_scan import ops as ssd_ops
        # B and C are slices of one projection: the kernel takes them dense
        return ssd_ops.ssd_scan(xr, dtr, Br.contiguous(), Cr.contiguous(), la, D)

    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    h = torch.zeros((b, H, N, Pd), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        # one chunk at a time: peak temp is (b,Q,Q,H) not (b,nc,Q,Q,H)
        la_c, x_c, b_c, c_c, dt_c = la[:, c], xr[:, c], Br[:, c], Cr[:, c], dtr[:, c]
        lcum = torch.cumsum(la_c, dim=1)                             # (b,Q,H)
        seg = lcum[:, :, None, :] - lcum[:, None, :, :]              # (b,Q,Q,H)
        # masked before the exp, as in ``kernels/ssd_scan/ref.py`` (which
        # says why): the reference's exp-then-mask has NaN gradients
        L = torch.exp(torch.where(causal[None, :, :, None], seg, -torch.inf))
        cb = torch.einsum("bin,bjn->bij", c_c, b_c)                  # (b,Q,Q)
        w = cb[..., None] * L                                        # (b,Q,Q,H)
        xdt = x_c.float() * dt_c[..., None]                          # (b,Q,H,P)
        y = torch.einsum("bijh,bjhp->bihp", w, xdt)                  # intra-chunk
        y = y + torch.einsum("bin,bhnp->bihp", c_c, h) * \
            torch.exp(lcum)[..., None]                               # inter-chunk
        decay_to_end = torch.exp(lcum[:, -1:, :] - lcum)             # (b,Q,H)
        s_c = torch.einsum("bjn,bjhp->bhnp", b_c, xdt * decay_to_end[..., None])
        h = h * torch.exp(lcum[:, -1, :])[..., None, None] + s_c
        ys.append(y)
    y = torch.stack(ys, dim=1).to(x.dtype).reshape(b, S, H, Pd)
    y = y + (D[:, None] * x.float()).to(x.dtype)
    return y, h


class MambaCache(NamedTuple):
    conv_x: torch.Tensor   # (B, K-1, d_inner) last inputs to the x conv
    conv_bc: torch.Tensor  # (B, K-1, 2N)
    h: torch.Tensor        # (B, H, N, P) SSM state, fp32

    @staticmethod
    def init(batch, d_model, *, expand=2, headdim=64, ssm_state=128,
             conv_dim=4, dtype=torch.bfloat16, device=None):
        d_inner = expand * d_model
        H = d_inner // headdim
        return MambaCache(
            conv_x=torch.zeros((batch, conv_dim - 1, d_inner), dtype=dtype, device=device),
            conv_bc=torch.zeros((batch, conv_dim - 1, 2 * ssm_state), dtype=dtype,
                                device=device),
            h=torch.zeros((batch, H, ssm_state, headdim), dtype=torch.float32,
                          device=device),
        )


def _shapes(p):
    d_inner = p.out_proj.shape[0]
    H = p.A_log.shape[0]
    return d_inner, H, d_inner // H, p.in_bc.shape[1] // 2


def mamba2_forward(p, u, *, chunk=256, use_kernel=False):
    """u: (B, S, D) -> (B, S, D); returns (out, final_state)."""
    Bsz, S, _ = u.shape
    d_inner, H, Pd, N = _shapes(p)
    z = u @ p.in_z
    x = u @ p.in_x
    bc = u @ p.in_bc
    dt = u @ p.in_dt
    x = _causal_conv(x, p.conv_x, p.conv_x_b).reshape(Bsz, S, H, Pd)
    bc = _causal_conv(bc, p.conv_bc, p.conv_bc_b)
    Bm, Cm = bc[..., :N], bc[..., N:]
    dt = F.softplus(dt.float() + p.dt_bias)
    y, h_last = ssd_chunked(x, dt, Bm, Cm, p.A_log, p.D, chunk, use_kernel=use_kernel)
    y = y.reshape(Bsz, S, d_inner)
    y = rmsnorm(y, p.norm_w) * F.silu(z)
    return y @ p.out_proj, h_last


def ssm_layer(lp, h, cfg):
    """One :class:`SSMLayer` with its residual: ``h + mixer(rmsnorm(h))``
    (the body of the reference's layer scan)."""
    out, _ = mamba2_forward(lp, rmsnorm(h, lp.ln, cfg.norm_eps), chunk=cfg.ssm_chunk,
                            use_kernel=cfg.use_ssd_kernel)
    return h + out


def mamba2_decode(p, u, cache: MambaCache):
    """u: (B, D) single token. Returns (out (B, D), cache). Unlike the
    reference, which returns a new cache, this updates ``cache``'s tensors
    in place (the conv windows shift by one token, ``h`` takes the new
    state) and returns it."""
    Bsz, _ = u.shape
    d_inner, H, Pd, N = _shapes(p)
    z = u @ p.in_z
    x = u @ p.in_x
    bc = u @ p.in_bc
    dt = u @ p.in_dt
    # causal conv over (cached K-1 inputs, current token)
    wx = torch.cat([cache.conv_x, x[:, None, :]], dim=1)             # (B,K,C)
    x = F.silu(torch.einsum("bkc,kc->bc", wx, p.conv_x) + p.conv_x_b)
    wbc = torch.cat([cache.conv_bc, bc[:, None, :]], dim=1)
    bc = F.silu(torch.einsum("bkc,kc->bc", wbc, p.conv_bc) + p.conv_bc_b)
    x = x.reshape(Bsz, H, Pd).float()
    Bm = bc[..., :N].float()
    Cm = bc[..., N:].float()
    dt = F.softplus(dt.float() + p.dt_bias)                          # (B,H)
    A = -torch.exp(p.A_log)
    decay = torch.exp(dt * A)                                        # (B,H)
    xdt = x * dt[..., None]                                          # (B,H,P)
    h = cache.h.mul_(decay[..., None, None]).add_(
        torch.einsum("bn,bhp->bhnp", Bm, xdt))
    y = torch.einsum("bn,bhnp->bhp", Cm, h) + p.D[:, None] * x
    y = y.reshape(Bsz, d_inner).to(u.dtype)
    y = rmsnorm(y, p.norm_w) * F.silu(z)
    cache.conv_x.copy_(wx[:, 1:, :])
    cache.conv_bc.copy_(wbc[:, 1:, :])
    return y @ p.out_proj, cache
