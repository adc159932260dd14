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
from torch.distributed.tensor import DTensor

from ..distributed.sharding import (entry_axes, linear, shard_map, spec_for, spec_of,
                                    unshard_unless_divides)
from .layers import _init, rmsnorm, rmsnorm_init


class Mamba2(nn.Module):
    """One Mamba2 mixer. ``A_log``, ``D``, ``dt_bias`` and ``norm_w`` stay
    fp32 in a bf16 model and keep the reference's constant inits
    (A = -exp(0) = -1, D = 1, softplus(-2) ~ 0.13, norm 1).
    ``generator=None`` leaves the drawn weights uninitialised (they are
    about to be loaded)."""

    AXES = {"in_x": ("embed", "mlp"), "in_z": ("embed", "mlp"),
            "in_bc": ("embed", None),      # B/C are shared across heads: replicate
            "in_dt": ("embed", "heads"), "conv_x": ("conv", "mlp"), "conv_x_b": ("mlp",),
            "conv_bc": ("conv", None), "conv_bc_b": (None,), "A_log": ("heads",),
            "D": ("heads",), "dt_bias": ("heads",), "norm_w": ("mlp",),
            "out_proj": ("mlp", "embed")}

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

    AXES = {**Mamba2.AXES, "ln": ("norm",)}

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
    """Depthwise causal conv, window K. x: (B, S, C); w: (K, C). Under a
    mesh it runs on each rank's batch and channels (the sequence whole),
    whose gradients of ``w`` and ``b`` are its batch's part."""
    if isinstance(x, DTensor):
        sx = tuple(spec_for(x.shape, ("batch", None, "mlp"), x.device_mesh)) + (None,) * 3
        bax, cax = sx[0], sx[2]
        fn = shard_map(_causal_conv, x.device_mesh,
                         in_specs=((bax, None, cax), (None, cax), (cax,)),
                         out_specs=(bax, None, cax),
                         partial_grads=[(), entry_axes(bax), entry_axes(bax)])
        return fn(x, w, b)
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    return F.silu(out + b)


def ssd_chunked(x, dt, B, C, A_log, D, chunk: int, use_kernel: bool = False):
    """SSD scan. x: (b, S, H, P); dt: (b, S, H); B, C: (b, S, N).
    Returns y: (b, S, H, P) and final state (b, H, N, P). S must be a
    multiple of ``chunk``, as in the reference."""
    if isinstance(x, DTensor):
        return _ssd_sharded(x, dt, B, C, A_log, D, chunk, use_kernel)
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


def _ssd_sharded(x, dt, B, C, A_log, D, chunk, use_kernel):
    """``ssd_chunked`` under a mesh: on each rank's batch and heads (the
    scan is independent across both), with B and C, shared across heads,
    whole on each rank. A rank's gradient of B and C is its heads' part,
    and of ``A_log`` and ``D`` its batch's part; the parts are added."""
    sx = tuple(spec_for(x.shape, ("batch", None, "heads", None), x.device_mesh)) + (None,) * 4
    bax, hax = sx[0], sx[2]
    fn = shard_map(lambda *a: ssd_chunked(*a, chunk, use_kernel), x.device_mesh,
                     in_specs=((bax, None, hax), (bax, None, hax), (bax,), (bax,), (hax,),
                               (hax,)),
                     out_specs=[(bax, None, hax), (bax, hax)],
                     partial_grads=[(), (), entry_axes(hax), entry_axes(hax),
                                    entry_axes(bax), entry_axes(bax)])
    return fn(x, dt, B, C, A_log, D)


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


#: the logical axes of a stack of caches (L, ...), the reference's
#: ``decode_state_axes`` leaves
MAMBA_CACHE_AXES = MambaCache(conv_x=("layers", "batch", "conv", "mlp"),
                              conv_bc=("layers", "batch", "conv", None),
                              h=("layers", "batch", "heads", "state", "head_dim"))


def _shapes(p):
    d_inner = p.out_proj.shape[0]
    H = p.A_log.shape[0]
    return d_inner, H, d_inner // H, p.in_bc.shape[1] // 2


def _gated_norm(y, z, w, gate_first):
    """The reference's ``rmsnorm(y) * silu(z)``, or with ``gate_first`` the
    published Mamba2's ``rmsnorm(y * silu(z))`` (over all channels: one
    group)."""
    if gate_first:
        return rmsnorm(y * F.silu(z), w)
    return rmsnorm(y, w) * F.silu(z)


def _window(t, K):
    """The last K-1 positions of t (B, S, C), zeros before the first."""
    S = t.shape[1]
    return F.pad(t[:, max(0, S - K + 1):], (0, 0, max(0, K - 1 - S), 0))


def mamba2_forward(p, u, *, chunk=256, use_kernel=False, gate_first=False, windows=False):
    """u: (B, S, D) -> (B, S, D); returns (out, final_state), or with
    ``windows`` (out, a ``MambaCache`` of the last K-1 conv inputs and the
    final state), from which decode continues the prompt."""
    Bsz, S, _ = u.shape
    d_inner, H, Pd, N = _shapes(p)
    z, x, bc, dt = (linear(u, w) for w in (p.in_z, p.in_x, p.in_bc, p.in_dt))
    if windows:
        K = p.conv_x.shape[0]
        conv_x, conv_bc = _window(x, K), _window(bc, K)
    x = unshard_unless_divides(_causal_conv(x, p.conv_x, p.conv_x_b), -1, H)
    x = x.reshape(Bsz, S, H, Pd)
    bc = _causal_conv(bc, p.conv_bc, p.conv_bc_b)
    Bm, Cm = bc[..., :N], bc[..., N:]
    dt = F.softplus(dt.float() + p.dt_bias)
    y, h_last = ssd_chunked(x, dt, Bm, Cm, p.A_log, p.D, chunk, use_kernel=use_kernel)
    y = y.reshape(Bsz, S, d_inner)
    out = linear(_gated_norm(y, z, p.norm_w, gate_first), p.out_proj)
    if windows:
        return out, MambaCache(conv_x, conv_bc, h_last)
    return out, h_last


def ssm_layer(lp, h, cfg):
    """One :class:`SSMLayer` with its residual: ``h + mixer(rmsnorm(h))``
    (the body of the reference's layer scan)."""
    out, _ = mamba2_forward(lp, rmsnorm(h, lp.ln, cfg.norm_eps), chunk=cfg.ssm_chunk,
                            use_kernel=cfg.use_ssd_kernel)
    return h + out


def _conv_step(x, w, b, window):
    """One token of the causal conv: x (B, C) after the cached K-1 inputs
    ``window`` (B, K-1, C), which shifts by one token in place."""
    wx = torch.cat([window, x[:, None, :]], dim=1)                   # (B,K,C)
    out = F.silu(torch.einsum("bkc,kc->bc", wx, w) + b)
    window.copy_(wx[:, 1:, :])
    return out


def _ssm_step(x, Bm, Cm, dt, A_log, D, h):
    """One token of the SSM recurrence: x (B,H,P) fp32, Bm/Cm (B,N), dt
    (B,H) after the softplus; the state h (B,H,N,P) is updated in place.
    Returns y (B,H,P) fp32."""
    A = -torch.exp(A_log)
    decay = torch.exp(dt * A)                                        # (B,H)
    xdt = x * dt[..., None]                                          # (B,H,P)
    h.mul_(decay[..., None, None]).add_(torch.einsum("bn,bhp->bhnp", Bm, xdt))
    return torch.einsum("bn,bhnp->bhp", Cm, h) + D[:, None] * x


def _on_cache_shards(fn, cache_t, in_specs, out_spec):
    """``fn`` on each rank's shards, with ``cache_t`` (a DTensor cache tensor,
    updated in place) taken as it is laid out; the other inputs are laid out
    to match it."""
    return shard_map(fn, cache_t.device_mesh, in_specs + (spec_of(cache_t),), out_spec)


def mamba2_decode(p, u, cache: MambaCache, gate_first=False):
    """u: (B, D) single token. Returns (out (B, D), cache). Unlike the
    reference, which returns a new cache, this updates ``cache``'s tensors
    in place (the conv windows shift by one token, ``h`` takes the new
    state) and returns it. Under a mesh the conv and the recurrence run on
    each rank's shards of the cache, as it is laid out. ``gate_first`` as
    in ``mamba2_forward``."""
    Bsz, _ = u.shape
    d_inner, H, Pd, N = _shapes(p)
    z, x, bc, dt = (linear(u, w) for w in (p.in_z, p.in_x, p.in_bc, p.in_dt))
    conv_x = conv_bc = _conv_step
    ssm = _ssm_step
    if isinstance(cache.h, DTensor):
        bax, _, cax = spec_of(cache.conv_x)
        conv_x = _on_cache_shards(_conv_step, cache.conv_x, ((bax, cax), (None, cax), (cax,)),
                                  (bax, cax))
        conv_bc = _on_cache_shards(_conv_step, cache.conv_bc, ((bax,), (), ()), (bax,))
        hb, hh = spec_of(cache.h)[:2]
        ssm = _on_cache_shards(_ssm_step, cache.h, ((hb, hh), (hb,), (hb,), (hb, hh), (hh,),
                                                    (hh,)), (hb, hh))
    x = conv_x(x, p.conv_x, p.conv_x_b, cache.conv_x)
    bc = conv_bc(bc, p.conv_bc, p.conv_bc_b, cache.conv_bc)
    x = unshard_unless_divides(x, -1, H).reshape(Bsz, H, Pd).float()
    dt = F.softplus(dt.float() + p.dt_bias)                          # (B,H)
    y = ssm(x, bc[..., :N].float(), bc[..., N:].float(), dt, p.A_log, p.D, cache.h)
    y = y.reshape(Bsz, d_inner).to(u.dtype)
    return linear(_gated_norm(y, z, p.norm_w, gate_first), p.out_proj), cache
