"""Granite 4.0-H (``model_type: granitemoehybrid``) for the benchmark: its
weights drawn from the seed, its config for the port, a plain float32
reference of its logits over a prompt and the tokens served after it, and
the counts of operations and bytes its metrics use.

The reference imports nothing of the program. With h the residual stream:

    h = embedding_multiplier * embed[tokens]
    h = h + residual_multiplier * mixer(rmsnorm(h))     # by layer_types
    h = h + residual_multiplier * moe(rmsnorm(h))       # every layer
    logits = rmsnorm(h) @ embed^T / logits_scaling

The Mamba2 mixer: x, z, B, C and dt projections (the published in_proj
split by rows, no bias), a depthwise causal convolution of width
``mamba_d_conv`` with bias and SiLU on x and on (B, C), dt through a softplus
after its bias, A = -exp(A_log), one group of B and C shared by every head,
the scan in closed form a chunk at a time (``mamba2.ssd``), the D skip, then
``rmsnorm(y * silu(z))`` over all channels (the gate before the norm, as
published), then out_proj. The attention mixer: q, k, v, o with no bias, no
position embedding, softmax(q.k^T * attention_multiplier), causal, GQA.
The MoE: the router's logits, the ``num_experts_per_tok`` largest, the
softmax over them, the SwiGLU experts as a loop over the rows routed to
each, nothing dropped, plus the ungated SwiGLU shared expert. The reference
runs the whole sequence (prompt and served tokens) at once, so the
convolution sees the prompt's last inputs when the served tokens begin.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..lib.flops import ssd_flops
from ..lib.quant import qmm
from .mamba2 import _conv, _rmsnorm, ssd


#: mamba2's size keys, which this config does not read: a copy cut to size
#: by them would keep every width (``bench/tests/tiny.py`` has no branch for
#: this model and cuts it so)
FOREIGN_KEYS = ("d_model", "n_layer", "d_state", "headdim", "chunk_size")


def _dims(c):
    if any(k in c for k in FOREIGN_KEYS):
        raise ValueError(f"granitemoehybrid: the config sets mamba2's keys "
                         f"{[k for k in FOREIGN_KEYS if k in c]}; cut it by its own")
    D = c["hidden_size"]
    d_in = c["mamba_expand"] * D
    H = c["mamba_n_heads"]
    if H * c["mamba_d_head"] != d_in or c["mamba_n_groups"] != 1:
        raise ValueError("granitemoehybrid: expects mamba_n_heads * mamba_d_head = "
                         "mamba_expand * hidden_size and one group")
    return D, d_in, H, c["mamba_d_head"], c["mamba_d_state"], c["mamba_d_conv"]


def _attn_dims(c):
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    return H, KV, c.get("head_dim") or c["hidden_size"] // H


def layer_types(c) -> list[str]:
    return c["layer_types"][:c["num_hidden_layers"]]


def port_config(c: dict, ModelConfig):
    """The port's ``ModelConfig`` for config file ``c``, its kernels on. The
    port's family has no rotary embedding (NoPE), as the config gives."""
    if c["position_embedding_type"] != "nope":
        raise ValueError("the port's moe_hybrid family runs NoPE attention only")
    D, d_in, H, P, N, _ = _dims(c)
    nh, kv, hd = _attn_dims(c)
    return ModelConfig(
        name=c["name"], family="moe_hybrid", n_layers=c["num_hidden_layers"], d_model=D,
        n_heads=nh, n_kv_heads=kv, head_dim=hd, vocab_size=logits_width(c),
        n_experts=c["num_local_experts"], n_experts_per_tok=c["num_experts_per_tok"],
        moe_d_ff=c["intermediate_size"], shared_d_ff=c["shared_intermediate_size"],
        ssm_state=N, ssm_expand=c["mamba_expand"], ssm_headdim=P,
        ssm_chunk=c["mamba_chunk_size"], tie_embeddings=c["tie_word_embeddings"],
        norm_eps=c["rms_norm_eps"], dtype=getattr(torch, c["dtype"]),
        layer_types=tuple(layer_types(c)), attn_scale=c["attention_multiplier"], embedding_multiplier=c["embedding_multiplier"],
        residual_multiplier=c["residual_multiplier"], logits_scaling=c["logits_scaling"],
        remat=c["port"]["remat"], use_flash=True, use_ssd_kernel=True)


def logits_width(c) -> int:
    """The vocabulary; the logits cover it all."""
    return c["vocab_size"]


def padded_vocab(c) -> int:
    """The embedding's rows as the port holds them: padded to 128."""
    return -(-logits_width(c) // 128) * 128


def _layer_shapes(c, kind):
    """The drawn N(0, initializer_range) tensors of one layer: ``state_dict``
    suffix -> shape."""
    D, d_in, H, _, N, _ = _dims(c)
    E, Fe, Fs = c["num_local_experts"], c["intermediate_size"], c["shared_intermediate_size"]
    if kind == "mamba":
        out = {"mamba.in_x": (D, d_in), "mamba.in_z": (D, d_in), "mamba.in_bc": (D, 2 * N),
               "mamba.in_dt": (D, H), "mamba.out_proj": (d_in, D)}
    else:
        nh, kv, hd = _attn_dims(c)
        out = {"attn.q": (D, nh, hd), "attn.k": (D, kv, hd), "attn.v": (D, kv, hd),
               "attn.o": (nh, hd, D)}
    return {**out, "moe.gate": (E, D, Fe), "moe.up": (E, D, Fe), "moe.down": (E, Fe, D),
            "moe.shared.gate": (D, Fs), "moe.shared.up": (D, Fs), "moe.shared.down": (Fs, D)}


def make_weights(c: dict, seed: int, device, dtype=None) -> dict:
    """Every parameter, keyed by the port's ``state_dict`` names, drawn a
    layer at a time (no float32 copy of more than one tensor is alive): the
    projections, the experts and the router N(0, initializer_range), the
    embedding that over ``embedding_multiplier``; the convolutions and their biases uniform in
    +-1/sqrt(d_conv); A_log = log of U(1, 16), dt_bias the inverse softplus
    of a dt log-uniform in [1e-3, 1e-1], D = 1; norm weights 1. The router,
    A_log, D, dt_bias and the norms are float32."""
    dtype = dtype or getattr(torch, c["dtype"])
    std = c["initializer_range"]
    gen = torch.Generator(device=device).manual_seed(seed & (2**63 - 1))
    D, d_in, H, _, N, K = _dims(c)

    def draw(shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=device).mul_(std).to(dt)

    def uniform(shape, lo, hi, dt=torch.float32):
        return (torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo).to(dt)

    def ones(n):
        return torch.ones(n, device=device)

    # the embedding at initializer_range / embedding_multiplier, so that the
    # scaled input is N(0, initializer_range): tied to the logits at the full
    # range, a random model's input token would outscore every other by ~8 of
    # their standard deviations, and every served token would repeat the last
    W = {"embed": draw((padded_vocab(c), D)).div_(c["embedding_multiplier"])}
    b = 1 / math.sqrt(K)
    for i, kind in enumerate(layer_types(c)):
        lw = {name: draw(shape) for name, shape in _layer_shapes(c, kind).items()}
        lw["moe.router"] = draw((D, c["num_local_experts"]), torch.float32)
        if kind == "mamba":
            lw["mamba.conv_x"] = uniform((K, d_in), -b, b, dtype)
            lw["mamba.conv_x_b"] = uniform((d_in,), -b, b, dtype)
            lw["mamba.conv_bc"] = uniform((K, 2 * N), -b, b, dtype)
            lw["mamba.conv_bc_b"] = uniform((2 * N,), -b, b, dtype)
            lw["mamba.A_log"] = uniform((H,), 1.0, 16.0).log_()
            dt = uniform((H,), math.log(1e-3), math.log(1e-1)).exp_()
            lw["mamba.dt_bias"] = dt + torch.log(-torch.expm1(-dt))     # softplus^-1(dt)
            lw["mamba.D"] = ones(H)
            lw["mamba.norm_w"] = ones(d_in)
        lw["ln1"], lw["ln2"] = ones(D), ones(D)
        W.update({f"layers.{i}.{k}": t for k, t in lw.items()})
    W["final_norm"] = ones(D)
    return W


# --------------------------------------------------------------------------
# The plain reference
# --------------------------------------------------------------------------
def _mamba(p, u, c, quant):
    D, d_in, H, P, N, _ = _dims(c)
    b, S, _ = u.shape
    z, x, bc, dt = (qmm(u, p(f"mamba.{n}"), quant) for n in ("in_z", "in_x", "in_bc", "in_dt"))
    x = _conv(x, p("mamba.conv_x"), p("mamba.conv_x_b")).reshape(b, S, H, P)
    bc = _conv(bc, p("mamba.conv_bc"), p("mamba.conv_bc_b"))
    dt = F.softplus(dt + p("mamba.dt_bias"))
    h0 = torch.zeros((b, H, N, P), device=u.device)
    y, _ = ssd(x, dt, -torch.exp(p("mamba.A_log")), bc[..., :N], bc[..., N:], h0,
               c["mamba_chunk_size"])
    y = (y + p("mamba.D")[:, None] * x).reshape(b, S, d_in)
    y = _rmsnorm(y * F.silu(z), p("mamba.norm_w"), c["rms_norm_eps"])
    return qmm(y, p("mamba.out_proj"), quant)


def _attention(p, u, c, quant, q_block=1024):
    """Causal GQA with no position embedding, a block of queries at a time."""
    b, S, D = u.shape
    nh, kv, hd = _attn_dims(c)
    q = qmm(u, p("attn.q").reshape(D, -1), quant).reshape(b, S, kv, nh // kv, hd)
    k = qmm(u, p("attn.k").reshape(D, -1), quant).reshape(b, S, kv, hd)
    v = qmm(u, p("attn.v").reshape(D, -1), quant).reshape(b, S, kv, hd)
    pos = torch.arange(S, device=u.device)
    outs = []
    for q0 in range(0, S, q_block):
        qb = q[:, q0:q0 + q_block]
        s = torch.einsum("bskgh,btkh->bkgst", qb, k) * c["attention_multiplier"]
        mask = pos[None, :] <= pos[q0:q0 + q_block, None]
        w = torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1)
        outs.append(torch.einsum("bkgst,btkh->bskgh", w, v))
    o = torch.cat(outs, dim=1).reshape(b, S, nh * hd)
    return qmm(o, p("attn.o").reshape(nh * hd, D), quant)


def _swiglu(x, wg, wu, wd, quant):
    return qmm(F.silu(qmm(x, wg, quant)) * qmm(x, wu, quant), wd, quant)


def _moe(p, u, c, quant):
    """The routed experts as a loop over the rows each is given, and the
    shared expert."""
    shape = u.shape
    u = u.reshape(-1, shape[-1])
    top, idx = torch.topk(qmm(u, p("moe.router"), quant), c["num_experts_per_tok"], dim=-1)
    w = torch.softmax(top, dim=-1)
    gate, up, down = p("moe.gate"), p("moe.up"), p("moe.down")
    y = _swiglu(u, p("moe.shared.gate"), p("moe.shared.up"), p("moe.shared.down"), quant)
    for e in range(c["num_local_experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            # a token picks an expert at most once: the rows are distinct
            y[rows] += _swiglu(u[rows], gate[e], up[e], down[e], quant) * w[rows, slot, None]
    return y.reshape(shape)


def served_logits(Wt, prompts, served, c, quant=None):
    """Logits (b, n, V) that predict each of the ``n`` served tokens of ``b``
    requests of one prompt length: position S-1 of the prompt, then each
    served token but the last, from one pass over the prompt and the served
    tokens. ``prompts`` (b, S), ``served`` (b, n) int; ``Wt(name)`` gives a
    parameter in float32. ``quant``: the number format of the operands of
    every product with a weight (None: exact float32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    S = prompts.shape[1]
    if served.shape[1] < 2:
        raise ValueError("served_logits: needs two served tokens or more")
    eps, r = c["rms_norm_eps"], c["residual_multiplier"]
    h = Wt("embed")[torch.cat([prompts, served[:, :-1]], dim=1)] * c["embedding_multiplier"]
    for i, kind in enumerate(layer_types(c)):
        p = lambda n: Wt(f"layers.{i}.{n}")  # noqa: E731
        mixer = _mamba if kind == "mamba" else _attention
        h = h + r * mixer(p, _rmsnorm(h, p("ln1"), eps), c, quant)
        h = h + r * _moe(p, _rmsnorm(h, p("ln2"), eps), c, quant)
    h = _rmsnorm(h[:, S - 1:], Wt("final_norm"), eps)
    return qmm(h, Wt("embed")[:logits_width(c)].t(), quant) / c["logits_scaling"]


# --------------------------------------------------------------------------
# Operations and bytes: matrix products and the sequence mixers, 2 FLOPs a
# multiply-add; norms, activations, routing and the lookup are not counted
# --------------------------------------------------------------------------
def moe_gemm_flops(c: dict, tokens: int) -> int:
    """The routed experts' three products in one MoE layer over ``tokens``
    tokens: every assignment computed (nothing is dropped)."""
    return 6 * tokens * c["num_experts_per_tok"] * c["hidden_size"] * c["intermediate_size"]


def moe_gemm_bytes(c: dict, tokens: int, dtype_bytes: int = 2) -> int:
    """Their least traffic: every expert's weights read once and each routed
    row read in and written out once."""
    E, D, Fe = c["num_local_experts"], c["hidden_size"], c["intermediate_size"]
    rows = tokens * c["num_experts_per_tok"]
    return dtype_bytes * (3 * E * D * Fe + 2 * rows * D)


def _per_token(c: dict) -> dict:
    """Weight FLOPs a token of each kind of layer, and of the logits."""
    D, d_in, H, P, N, K = _dims(c)
    nh, kv, hd = _attn_dims(c)
    moe = 2 * (3 * D * c["intermediate_size"] * c["num_experts_per_tok"]
               + 3 * D * c["shared_intermediate_size"] + D * c["num_local_experts"])
    return {"mamba": 2 * (D * (2 * d_in + 2 * N + H) + d_in * D + K * (d_in + 2 * N)) + moe,
            "attention": 2 * (D * (nh + 2 * kv) * hd + nh * hd * D) + moe,
            "logits": 2 * D * c["vocab_size"]}


def prefill_flops(c: dict, batch: int, seq: int) -> int:
    """A prefill of ``batch`` prompts of ``seq`` tokens: every layer's
    products, the SSD scans and the causal attention, then the logits of
    the last position only."""
    D, d_in, H, P, N, _ = _dims(c)
    nh, _, hd = _attn_dims(c)
    per, Q = _per_token(c), c["mamba_chunk_size"]
    out = per["logits"] * batch
    for kind in layer_types(c):
        out += per[kind] * batch * seq
        out += ssd_flops((batch, seq // Q, Q, H, P, N)) if kind == "mamba" \
            else 4 * hd * nh * (seq * (seq + 1) // 2) * batch
    return out


def decode_flops(c: dict, batch: int, context: int) -> int:
    """One decode step of ``batch`` sequences whose new token sits at position
    ``context``: the products, the state update and its read-out (2 H N P
    multiply-adds), attention over ``context + 1`` keys, and the logits."""
    D, d_in, H, P, N, _ = _dims(c)
    nh, _, hd = _attn_dims(c)
    per = _per_token(c)
    out = per["logits"]
    for kind in layer_types(c):
        out += per[kind] + (4 * H * N * P if kind == "mamba" else 4 * hd * nh * (context + 1))
    return batch * out
