"""Median of the window's train steps, each timed on the host to the loss
read back (a device sync), leaving out the steps that ran while a save was
in flight."""
from bench.lib.stats import median


def read(run):
    steps = [s for s in run.spans.of("train.step") if not s.get("inflight")]
    return median([s["t1"] - s["t0"] for s in steps]) * 1e3 if steps else None
