"""Mamba2 (``model_type: mamba2``, arXiv:2405.21060) for the benchmark: its
weights drawn from the seed, its config for the port, and a plain float32
reference of its logits over a prompt and the tokens served after it.

The reference imports nothing of the program. Each layer is
``h + out_proj(rmsnorm(ssd(conv(x))) * silu(z))`` of ``rmsnorm(h)``, with
x, z, B, C and dt their own projections, a depthwise causal convolution of
width ``d_conv`` and SiLU on x and on (B, C), dt through a softplus after
its bias, A = -exp(A_log), one group of B and C shared by every head, and
the scan in closed form a chunk at a time (a quadratic term inside the
chunk, the state carried across chunks), masked before the exponential.
Two departures from the published block, both the program's, are
followed: the gate multiplies after the norm, and a served token's
convolution window starts empty after the prompt (the program's decode
starts with fresh convolution windows; only the SSM state carries the
prompt over).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..lib.quant import qmm


def _dims(c):
    D = c["d_model"]
    d_in = c["expand"] * D
    return D, d_in, d_in // c["headdim"], c["headdim"], c["d_state"], c["d_conv"]


def _layer_shapes(c):
    """The drawn matrices of one layer: ``state_dict`` suffix -> shape."""
    D, d_in, H, _, N, K = _dims(c)
    return {"in_x": (D, d_in), "in_z": (D, d_in), "in_bc": (D, 2 * N), "in_dt": (D, H),
            "out_proj": (d_in, D)}


def port_config(c: dict, ModelConfig):
    """The port's ``ModelConfig`` for config file ``c``, its kernel on."""
    return ModelConfig(
        name=c["name"], family="ssm", n_layers=c["n_layer"], d_model=c["d_model"],
        vocab_size=logits_width(c), ssm_state=c["d_state"], ssm_headdim=c["headdim"],
        ssm_expand=c["expand"], ssm_chunk=c["chunk_size"], tie_embeddings=c["tie_embeddings"],
        norm_eps=c["norm_epsilon"], dtype=getattr(torch, c["dtype"]), subquadratic=True,
        remat=c["port"]["remat"], use_ssd_kernel=True)


def logits_width(c) -> int:
    """Rows of the embedding the model has: the tokenizer's vocabulary padded
    to ``pad_vocab_size_multiple``; the logits cover them all."""
    m = c["pad_vocab_size_multiple"]
    return -(-c["vocab_size"] // m) * m


def padded_vocab(c) -> int:
    """The embedding's rows as the port holds them: padded to 128."""
    return -(-logits_width(c) // 128) * 128


def make_weights(c: dict, seed: int, device, dtype=None) -> dict:
    """Every parameter, keyed by the port's ``state_dict`` names, one draw a
    kind over all layers: the embedding and the projections N(0,
    initializer_range); the convolutions and their biases uniform in
    +-1/sqrt(d_conv) (a depthwise convolution's default); A_log = log of
    U(1, 16), dt_bias the inverse softplus of a dt log-uniform in [1e-3,
    1e-1], D = 1 (mamba_ssm's init); norm weights 1. A_log, D, dt_bias and
    the norms are float32."""
    dtype = dtype or getattr(torch, c["dtype"])
    std = c["initializer_range"]
    gen = torch.Generator(device=device).manual_seed(seed & (2**63 - 1))
    L = c["n_layer"]
    D, d_in, H, _, N, K = _dims(c)

    def draw(shape, scale=std):
        return torch.randn(shape, generator=gen, device=device).mul_(scale).to(dtype)

    def uniform(shape, lo, hi, dt=torch.float32):
        return (torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo).to(dt)

    stacked = {name: draw((L, *shape)) for name, shape in _layer_shapes(c).items()}
    b = 1 / math.sqrt(K)
    stacked["conv_x"] = uniform((L, K, d_in), -b, b, dtype)
    stacked["conv_x_b"] = uniform((L, d_in), -b, b, dtype)
    stacked["conv_bc"] = uniform((L, K, 2 * N), -b, b, dtype)
    stacked["conv_bc_b"] = uniform((L, 2 * N), -b, b, dtype)
    stacked["A_log"] = uniform((L, H), 1.0, 16.0).log_()
    dt = uniform((L, H), math.log(1e-3), math.log(1e-1)).exp_()
    stacked["dt_bias"] = dt + torch.log(-torch.expm1(-dt))      # softplus^-1(dt)
    stacked["D"] = torch.ones((L, H), device=device)
    stacked["norm_w"] = torch.ones((L, d_in), device=device)
    stacked["ln"] = torch.ones((L, D), device=device)
    W = {"embed": draw((padded_vocab(c), D))}
    for name, t in stacked.items():
        for i in range(L):
            W[f"layers.{i}.{name}"] = t[i]
    W["final_norm"] = torch.ones(D, device=device)
    return W


# --------------------------------------------------------------------------
# The plain reference
# --------------------------------------------------------------------------
def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _conv(x, w, b):
    """Depthwise causal convolution of x (B, S, C) by w (K, C), zeros before
    the first position, then SiLU."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return F.silu(sum(xp[:, i:i + S] * w[i] for i in range(K)) + b)


def ssd(x, dt, A, Bm, Cm, h, chunk):
    """The scan y_t = C_t . h_t, h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
    a chunk at a time. x (b, S, H, P), dt (b, S, H), Bm, Cm (b, S, N), A (H,),
    h (b, H, N, P) the state before the first position. Returns y and the
    state after the last. Any S: the last chunk may be short."""
    ys = []
    for s0 in range(0, x.shape[1], chunk):
        xc, dtc = x[:, s0:s0 + chunk], dt[:, s0:s0 + chunk]
        bc, cc = Bm[:, s0:s0 + chunk], Cm[:, s0:s0 + chunk]
        Q = xc.shape[1]
        lcum = torch.cumsum(dtc * A, dim=1)                          # (b, Q, H)
        seg = lcum[:, :, None] - lcum[:, None]                       # (b, Q, Q, H)
        causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~causal[None, :, :, None], -torch.inf))
        xdt = xc * dtc[..., None]
        w = torch.einsum("bin,bjn->bij", cc, bc)[..., None] * decay
        y = torch.einsum("bijh,bjhp->bihp", w, xdt)
        y = y + torch.einsum("bin,bhnp->bihp", cc, h) * torch.exp(lcum)[..., None]
        to_end = torch.exp(lcum[:, -1:] - lcum)
        h = h * torch.exp(lcum[:, -1])[..., None, None] \
            + torch.einsum("bjn,bjhp->bhnp", bc, xdt * to_end[..., None])
        ys.append(y)
    return torch.cat(ys, dim=1), h


def served_logits(Wt, prompts, served, c, quant=None):
    """Logits (b, n, V) that predict each of the ``n`` served tokens of ``b``
    requests of one prompt length: position S-1 of the prompt, then each
    served token but the last. ``prompts`` (b, S), ``served`` (b, n) int;
    ``Wt(name)`` gives a parameter in float32. ``quant``: the number format
    of every matrix product's operands (None: exact float32)."""
    D, d_in, H, P, N, _ = _dims(c)
    eps, Q = c["norm_epsilon"], c["chunk_size"]
    b, S = prompts.shape
    if served.shape[1] < 2:
        raise ValueError("served_logits: needs two served tokens or more")
    segs = [Wt("embed")[prompts], Wt("embed")[served[:, :-1]]]
    for i in range(c["n_layer"]):
        p = lambda n: Wt(f"layers.{i}.{n}")  # noqa: E731
        state = torch.zeros((b, H, N, P), device=prompts.device)
        A = -torch.exp(p("A_log"))
        for j, hseg in enumerate(segs):
            u = _rmsnorm(hseg, p("ln"), eps)
            z, x, bc, dt = (qmm(u, p(n), quant) for n in ("in_z", "in_x", "in_bc", "in_dt"))
            x = _conv(x, p("conv_x"), p("conv_x_b"))
            bc = _conv(bc, p("conv_bc"), p("conv_bc_b"))
            dt = F.softplus(dt + p("dt_bias"))
            L_ = x.shape[1]
            y, state = ssd(x.reshape(b, L_, H, P), dt, A, bc[..., :N], bc[..., N:], state, Q)
            y = y + p("D")[:, None] * x.reshape(b, L_, H, P)
            y = _rmsnorm(y.reshape(b, L_, d_in), p("norm_w"), 1e-5) * F.silu(z)
            segs[j] = hseg + qmm(y, p("out_proj"), quant)
    h = torch.cat([segs[0][:, -1:], segs[1]], dim=1)
    h = _rmsnorm(h, Wt("final_norm"), eps)
    return qmm(h, Wt("embed")[:logits_width(c)].t(), quant)
