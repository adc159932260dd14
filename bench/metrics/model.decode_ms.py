"""Median decode step in the window, timed on the host from the call to its
tokens read back (a device sync)."""
from bench.lib.stats import median


def read(run):
    spans = run.spans.of("serve.decode")
    return median([s["t1"] - s["t0"] for s in spans]) * 1e3 if spans else None
