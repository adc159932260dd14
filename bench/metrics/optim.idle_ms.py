"""Device idle time a traced train step that begins while the host is in
AdamW: the idle stretches of the traced region (any length) that open
inside an ``optim.adamw`` range of the port (``repro_torch.spans``),
summed, over the number of traced steps."""
from bench.lib.program_spans import idle_gaps, inside, ranges


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    steps, opt = t.marks_named("bench.train_step"), ranges(t, "optim.adamw")
    if not steps or not opt:
        return None
    idle_us = sum(g1 - g0 for g0, g1 in idle_gaps(t) if inside(opt, g0))
    return idle_us / 1e3 / len(steps)
