"""Kernels launched in one decode step: the device kernels (copies and fills
left out) that start inside each traced decode step, the median over the
steps (each ends on a device sync, so the count is exact)."""
from bench.lib.stats import median


def read(run):
    t = run.trace
    if t is None:
        return None
    counts = [sum(1 for k in t.kernels_in(m) if not k[0].startswith(("Memcpy", "Memset")))
              for m in t.marks_named("bench.decode")]
    return float(median(counts)) if counts else None
