"""The yardstick's arithmetic: the H100's published peaks, the roofline
bounds of the two hand-written kernels, and the model FLOPs that the MFU
metrics count. Frozen here: a later change to the program cannot move it.

``flash_bound`` and ``ssd_bound`` are copies of ``chip_smoke.py``'s, with
the mask counted in closed form instead of on a tensor.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense, at the full 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def _causal_pairs(S: int, window: int) -> int:
    """Valid (query, key) pairs of a causal mask over S positions, with a
    sliding window of ``window`` keys (0: unbounded)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    w = window
    return w * (w + 1) // 2 + (S - w) * w


def flash_bound(case, dtype: str):
    """(seconds, "bytes" | "operations") for one flash-attention call of
    ``case = (B, S, H, KV, hd, causal, window)``: the larger of the traffic
    (q, k, v read once, o written once) over the memory rate and the work
    of the valid (q, k) pairs (two products of 2*hd FLOPs each) over the
    peak rate for the input type."""
    B, S, H, KV, hd, causal, window = case
    if causal:
        pairs = _causal_pairs(S, window)
    else:
        # keys after q - window, as chip_smoke.py's mask has it
        pairs = S * S if not window else sum(S - max(0, q - window + 1) for q in range(S))
    flops = 4 * hd * pairs * B * H
    nbytes = B * S * (2 * H + 2 * KV) * hd * (4 if dtype == "float32" else 2)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ssd_flops(case) -> int:
    """Work of one SSD scan of ``case = (b, nc, Q, H, P, N)``: C.B^T over the
    causal pairs once per (batch, chunk), and per head the intra-chunk
    product over the causal pairs, the inter-chunk product and the state
    update, 2 FLOPs a multiply-add."""
    b, nc, Q, H, P, N = case
    pairs = Q * (Q + 1) // 2
    return 2 * b * nc * (pairs * N + H * (pairs * P + 2 * Q * N * P))


def ssd_bound(case, dtype: str):
    """(seconds, "bytes" | "operations") for one SSD scan: the larger of the
    traffic (x, dt, la, B, C, D read once, y and h_last written once) over
    the memory rate and ``ssd_flops`` over the peak rate for x's type."""
    b, nc, Q, H, P, N = case
    xb = 4 if dtype == "float32" else 2
    nbytes = (2 * b * nc * Q * H * P * xb + 4 * (2 * b * nc * Q * H + 2 * b * nc * Q * N
                                                 + H + b * H * N * P))
    t_ops, t_bytes = ssd_flops(case) / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# --------------------------------------------------------------------------
# Model FLOPs: matrix products and the sequence mixer, 2 FLOPs a
# multiply-add; norms, activations and the embedding lookup are not counted
# --------------------------------------------------------------------------
def llama_forward_flops(c: dict, batch: int, seq: int) -> int:
    """One forward pass of a llama-style decoder over ``batch`` sequences of
    ``seq`` tokens, causal, logits at every position. ``c`` is a config file
    (Hugging Face keys)."""
    D, L, V = c["hidden_size"], c["num_hidden_layers"], c["vocab_size"]
    H, KV, F = c["num_attention_heads"], c["num_key_value_heads"], c["intermediate_size"]
    hd = c.get("head_dim") or D // H
    per_token = L * (D * (H + 2 * KV) * hd + H * hd * D + 3 * D * F) + D * V
    attn = L * 4 * hd * H * _causal_pairs(seq, 0)
    return 2 * per_token * batch * seq + attn * batch


def llama_train_flops(c: dict, batch: int, seq: int) -> int:
    """Forward and backward of one training step: three forwards. The
    recomputation of checkpointed layers is not counted."""
    return 3 * llama_forward_flops(c, batch, seq)


def _mamba2_dims(c: dict):
    D, L = c["d_model"], c["n_layer"]
    d_in = c["expand"] * D
    return D, L, d_in, d_in // c["headdim"], c["headdim"], c["d_state"], c["d_conv"]


def mamba2_prefill_flops(c: dict, batch: int, seq: int) -> int:
    """A prefill of ``batch`` prompts of ``seq`` tokens: the projections, the
    depthwise convolutions and the chunked SSD scan of every layer, then the
    logits of the last position only."""
    D, L, d_in, H, P, N, K = _mamba2_dims(c)
    proj = D * (2 * d_in + 2 * N + H) + d_in * D
    conv = K * (d_in + 2 * N)
    Q = c["chunk_size"]
    scan = ssd_flops((batch, seq // Q, Q, H, P, N))
    return L * (2 * (proj + conv) * batch * seq + scan) + 2 * D * c["vocab_size"] * batch


def mamba2_decode_flops(c: dict, batch: int) -> int:
    """One decode step of ``batch`` sequences: the projections, the conv
    step, the state update and its read-out, and the logits."""
    D, L, d_in, H, P, N, K = _mamba2_dims(c)
    proj = D * (2 * d_in + 2 * N + H) + d_in * D
    conv = K * (d_in + 2 * N)
    state = 2 * H * N * P
    return batch * (L * 2 * (proj + conv + state) + 2 * D * c["vocab_size"])
