"""A llama-style decoder (``model_type: llama``, e.g. SmolLM) for the
benchmark: its weights drawn from the seed, its config for the port, and a
plain float32 reference of its loss, gradients and AdamW steps.

The reference imports nothing of the program. It follows the published
architecture (pre-norm RMSNorm blocks, RoPE on split halves, grouped-query
causal attention, SwiGLU MLP, tied embeddings) in float32 with TF32 off,
from the same bf16 weights the program is handed, and keeps updated
weights in the configuration's dtype, as the program does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..lib.quant import qmm


def _layer_shapes(c):
    """The matrices of one layer: ``state_dict`` suffix -> shape."""
    D, H, KV, Fd = (c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"],
                    c["intermediate_size"])
    hd = c.get("head_dim") or D // H
    return {"attn.q": (D, H, hd), "attn.k": (D, KV, hd), "attn.v": (D, KV, hd),
            "attn.o": (H, hd, D), "mlp.gate": (D, Fd), "mlp.up": (D, Fd), "mlp.down": (Fd, D)}


def port_config(c: dict, ModelConfig):
    """The port's ``ModelConfig`` for config file ``c``, its kernels on."""
    return ModelConfig(
        name=c["name"], family="dense", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], head_dim=c.get("head_dim") or 0,
        tie_embeddings=c["tie_word_embeddings"], norm_eps=c["rms_norm_eps"],
        rope_theta=c["rope_theta"], dtype=getattr(torch, c["dtype"]),
        remat=c["port"]["remat"], use_flash=True)


def logits_width(c) -> int:
    return c["vocab_size"]


def padded_vocab(c) -> int:
    """The embedding's rows as the port holds them: padded to 128."""
    return -(-c["vocab_size"] // 128) * 128


def make_weights(c: dict, seed: int, device, dtype=None) -> dict:
    """Every parameter, keyed by the port's ``state_dict`` names: matrices and
    the embedding N(0, initializer_range), one draw a kind over all layers;
    norm weights 1 in fp32. The embedding has the vocabulary padded to a
    multiple of 128 rows; the padding rows are drawn too."""
    dtype = dtype or getattr(torch, c["dtype"])
    std = c["initializer_range"]
    gen = torch.Generator(device=device).manual_seed(seed & (2**63 - 1))
    L, D = c["num_hidden_layers"], c["hidden_size"]

    def draw(shape):
        t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return t.mul_(std).to(dtype)

    W = {"embed": draw((padded_vocab(c), D))}
    for name, shape in _layer_shapes(c).items():
        stacked = draw((L, *shape))
        for i in range(L):
            W[f"layers.{i}.{name}"] = stacked[i]
    for i in range(L):
        W[f"layers.{i}.ln1"] = torch.ones(D, device=device)
        W[f"layers.{i}.ln2"] = torch.ones(D, device=device)
    W["final_norm"] = torch.ones(D, device=device)
    return W


# --------------------------------------------------------------------------
# The plain reference
# --------------------------------------------------------------------------
def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """x (S, heads, hd): the two halves of each head rotated by position."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = (torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv).float()
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def row_logits(W, tokens, c, quant=None):
    """Logits (S, V) of one row of ``tokens`` (S,), float32; ``W`` holds
    float32 tensors. ``quant``: the lower-precision control's number format
    for every matrix product's operands (None: exact)."""
    D, H, KV = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    hd = c.get("head_dim") or D // H
    eps, theta, S = c["rms_norm_eps"], c["rope_theta"], tokens.shape[0]
    mask = torch.ones((S, S), dtype=torch.bool, device=tokens.device).tril()
    h = W["embed"][tokens]
    for i in range(c["num_hidden_layers"]):
        p = lambda n: W[f"layers.{i}.{n}"]  # noqa: E731
        x = _rmsnorm(h, p("ln1"), eps)
        q = _rope(qmm(x, p("attn.q").reshape(D, -1), quant).reshape(S, H, hd), theta)
        k = _rope(qmm(x, p("attn.k").reshape(D, -1), quant).reshape(S, KV, hd), theta)
        v = qmm(x, p("attn.v").reshape(D, -1), quant).reshape(S, KV, hd)
        k, v = (t.repeat_interleave(H // KV, dim=1) for t in (k, v))
        s = torch.einsum("shd,thd->hst", q, k) / math.sqrt(hd)
        a = torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1)
        o = torch.einsum("hst,thd->shd", a, v).reshape(S, H * hd)
        h = h + qmm(o, p("attn.o").reshape(H * hd, D), quant)
        x = _rmsnorm(h, p("ln2"), eps)
        f = F.silu(qmm(x, p("mlp.gate"), quant)) * qmm(x, p("mlp.up"), quant)
        h = h + qmm(f, p("mlp.down"), quant)
    h = _rmsnorm(h, W["final_norm"], eps)
    return qmm(h, W["embed"][:c["vocab_size"]].t(), quant)


def loss_and_grads(W, batch, c, quant=None, rows=None):
    """Mean next-token cross-entropy over ``batch`` (``tokens``, ``targets``,
    (B, S) tensors) and its gradient in every tensor of ``W`` (float32
    leaves that require grad), one row at a time so that it fits. ``rows``:
    the rows to take (default all)."""
    tokens, targets = batch["tokens"], batch["targets"]
    rows = range(tokens.shape[0]) if rows is None else rows
    for w in W.values():
        w.grad = None
    total = 0.0
    for r in rows:
        lg = row_logits(W, tokens[r], c, quant)
        loss = F.cross_entropy(lg, targets[r].long()) / len(rows)
        loss.backward()
        total += float(loss.detach())
        del lg, loss
    return total, {k: w.grad.detach() for k, w in W.items()}
