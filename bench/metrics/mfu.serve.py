"""Model FLOPs of the traced prefills and decode steps (counted from the
config) over the traced region's length times the H100's bf16 peak."""
from bench.lib.flops import PEAK_FLOPS, mamba2_decode_flops, mamba2_prefill_flops


def read(run):
    t, c = run.trace, run.c
    if t is None or not t.kernels or not t.marks:
        return None
    flops = 0
    for m in t.marks_named("bench.prefill"):
        b, S = (int(x) for x in m[0].split(":")[1].split("x"))
        flops += mamba2_prefill_flops(c, b, S)
    for m in t.marks_named("bench.decode"):
        flops += mamba2_decode_flops(c, int(m[0].split(":")[1]))
    return 100.0 * flops / (t.window_s * PEAK_FLOPS[c["dtype"]])
