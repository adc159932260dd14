"""Model FLOPs of the traced prefills and decode steps of a Granite 4.0-H
cell (``bench/models/granitemoehybrid.py``: products, SSD scans, attention
over the context each step has) over the traced region's length times the
H100's bf16 peak. A decode step's context is its prefill's length plus the
steps before it since that prefill."""
from bench.lib.flops import PEAK_FLOPS


def read(run):
    t, c = run.trace, run.c
    if t is None or not t.kernels or not t.marks:
        return None
    from bench.models.granitemoehybrid import decode_flops, prefill_flops
    flops, context = 0, None
    for name, _, _ in t.marks:                  # by start
        what, shape = name.split(":")
        if what == "bench.prefill":
            b, context = (int(x) for x in shape.split("x"))
            flops += prefill_flops(c, b, context)
        elif what == "bench.decode" and context is not None:
            flops += decode_flops(c, int(shape), context)
            context += 1
    return 100.0 * flops / (t.window_s * PEAK_FLOPS[c["dtype"]])
