"""Model FLOPs of the traced train steps (forward and backward, counted from
the config; recomputation not counted) over the traced region's length
times the H100's bf16 peak."""
from bench.lib.flops import PEAK_FLOPS, llama_train_flops


def read(run):
    t = run.trace
    if t is None or not t.kernels or not t.marks_named("bench.train_step"):
        return None
    n = len(t.marks_named("bench.train_step"))
    flops = n * llama_train_flops(run.c, run.tr["batch"], run.tr["seq"])
    return 100.0 * flops / (t.window_s * PEAK_FLOPS[run.c["dtype"]])
