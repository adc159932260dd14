"""The port's own spans (``repro_torch.spans``) as the torch profiler files
them in a traced region: host ranges among ``DeviceTrace.host_ops``, on the
device trace's clock (us). A program without such spans gives no ranges,
and the metrics that read them give None."""
from __future__ import annotations

import bisect


def ranges(trace, name: str) -> list[tuple[float, float]]:
    """[(start, end)] of the host ranges named ``name``, by start."""
    return [(s, e) for n, s, e in trace.host_ops if n == name]


def idle_gaps(trace) -> list[tuple[float, float]]:
    """[(start, end)] of every stretch of the traced region, however short,
    in which no operation ran on the device."""
    gaps, prev = [], trace.t0
    for _, s, e in trace.kernels:          # by start
        if s >= trace.t1 or e <= trace.t0:
            continue
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if trace.t1 > prev:
        gaps.append((prev, trace.t1))
    return gaps


def inside(spans: list[tuple[float, float]], t: float) -> bool:
    """Whether ``t`` falls in one of ``spans`` (sorted, none overlapping)."""
    i = bisect.bisect_right([s for s, _ in spans], t) - 1
    return i >= 0 and t < spans[i][1]
