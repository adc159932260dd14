"""Order statistics of the end-to-end metrics."""
from __future__ import annotations


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, linear between the
    nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def median(values) -> float:
    return percentile(values, 50.0)
