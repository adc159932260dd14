"""Share of its roofline the flash-attention kernel (K1) reached in the
traced train steps: each launch's bound (``flash_bound`` at the step's
attention shape, causal) summed, over the launches' device time. The
kernel's backward is not K1 and is not counted."""
from bench.lib.flops import flash_bound


def read(run):
    t, c, tr = run.trace, run.c, run.tr
    if t is None:
        return None
    ks = [k for m in t.marks_named("bench.train_step") for k in t.kernels_in(m)
          if "flash_fwd" in k[0]]
    if not ks:
        return None
    D, H = c["hidden_size"], c["num_attention_heads"]
    case = (tr["batch"], tr["seq"], H, c["num_key_value_heads"], c.get("head_dim") or D // H,
            True, 0)
    bound, _ = flash_bound(case, c["dtype"])
    return 100.0 * bound * len(ks) / (sum(e - s for _, s, e in ks) / 1e6)
