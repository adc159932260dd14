"""Share of its roofline the backward kernel of K1 reached in the traced
train steps: the bound of one backward call at the step's attention shape,
causal, times the calls (one a layer a step), over the device time of every
kernel whose name contains ``flash_bwd``. The bound is the larger of five
products of 2*hd FLOPs over the valid (q, k) pairs (S, dP, dV, dK, dQ) at the
peak for the input type and q, k, v, o and dO read plus dq, dk and dv written
at the memory rate. None where no such kernel ran: a backward that recomputes
the plain attention and differentiates it launches none."""
from bench.lib.flops import HBM_BYTES_PER_S, PEAK_FLOPS, _causal_pairs


def bwd_bound(B, S, H, KV, hd, dtype):
    """Seconds: the least time one causal backward call could take."""
    flops = 5 * 2 * hd * _causal_pairs(S, 0) * B * H
    nbytes = B * S * (4 * H + 4 * KV) * hd * (4 if dtype == "float32" else 2)
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def read(run):
    t, c, tr = run.trace, run.c, run.tr
    if t is None:
        return None
    steps = t.marks_named("bench.train_step")
    ks = [k for m in steps for k in t.kernels_in(m) if "flash_bwd" in k[0]]
    if not ks:
        return None
    D, H = c["hidden_size"], c["num_attention_heads"]
    bound = bwd_bound(tr["batch"], tr["seq"], H, c["num_key_value_heads"],
                      c.get("head_dim") or D // H, c["dtype"])
    calls = len(steps) * c["num_hidden_layers"]
    return 100.0 * bound * calls / (sum(e - s for _, s, e in ks) / 1e6)
