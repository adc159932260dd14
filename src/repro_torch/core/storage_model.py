"""Analytical storage congestion model (DESIGN.md §4).

Calibrated so the simulator reproduces the paper's MareNostrum-4 measurements:

* aggregate achieved throughput for ``k`` concurrent fsync'd writers on one
  device ramps linearly (per-stream cap ``s``) until it saturates the device
  bandwidth ``B`` at the knee ``k* = B/s``, then degrades with congestion:

      A(k) = min(k*s, B) / (1 + alpha * max(0, k - k*))

* per-task rate under fair sharing is A(k)/k.

With the paper's numbers (B=450 MB/s node-local SSD, 225 I/O executors) this
yields: unbounded learning phase 2->4->8->16 stopping after the 4th epoch,
objective choosing constraint 8, throughput peaking at constraint 8, and
non-constrained runs slower than the baseline — matching Figs. 10-12.
"""
from __future__ import annotations

from .resources import StorageDevice


def aggregate_throughput(device: StorageDevice, k: int) -> float:
    """Achieved aggregate MB/s with k concurrent streams on ``device``."""
    if k <= 0:
        return 0.0
    ramp = min(k * device.per_stream_cap, device.bandwidth)
    # degraded health scales what the hardware can deliver; the guard keeps
    # healthy-path arithmetic (and golden launch logs) byte-identical
    f = device.bw_factor
    if f != 1.0:
        ramp *= f
    over = max(0, k - device.congestion_knee)
    pen = device.congestion_alpha * over + device.congestion_beta * over * over
    return ramp / (1.0 + pen)


def per_task_rate(device: StorageDevice, k: int) -> float:
    """Fair-share MB/s each of k concurrent streams achieves.

    Memoized per (device, k): the curve depends only on the device's
    calibration and health, both of which invalidate the cache when they
    change (``StorageDevice.invalidate_rates``), so the cached float is
    always the exact value the open-form arithmetic would produce — the
    simulator's golden launch logs cannot tell the difference. On the
    100k-task benchmark this call dominates the event loop (~1.7M calls
    over ~40 distinct k values per device)."""
    if k <= 0:
        return 0.0
    cache = device._rate_cache
    r = cache.get(k)
    if r is None:
        r = cache[k] = aggregate_throughput(device, k) / k
    return r


def expected_task_time(device: StorageDevice, k: int, io_mb: float) -> float:
    """Time for one of k concurrent tasks writing io_mb (steady state)."""
    r = per_task_rate(device, k)
    return float("inf") if r <= 0 else io_mb / r


def max_concurrent_tasks(device_bw: float, constraint: float) -> int:
    """maxNumTasks_c (paper §3.3.2): floor(device bandwidth / constraint)."""
    return max(1, int(device_bw // constraint))


# --------------------------------------------------------------------------
# Cross-tier transfers (multi-tier hierarchy: SSD -> burst buffer -> FS)
# --------------------------------------------------------------------------
def read_floor_time(src: StorageDevice, mb: float) -> float:
    """Lower bound on reading ``mb`` from ``src``: a single sequential
    reader streams at most at the device bandwidth. Used as the ``min_end``
    floor of runtime-generated drain/prefetch tasks — the *write* side is
    what the simulator models dynamically (the task is placed on the
    destination tier, so it sees that device's congestion) — and as the
    data-lifecycle read penalty: the catalog charges consumers this floor
    for inputs pulled from their fastest resident tier (datalife.py), which
    is what auto-prefetch staging shrinks."""
    if mb <= 0:
        return 0.0
    return mb / src.bandwidth if src.bandwidth > 0 else float("inf")


def cross_tier_time(src: StorageDevice, dst: StorageDevice, mb: float,
                    k: int = 1) -> float:
    """Analytic estimate of moving ``mb`` from ``src`` to ``dst`` as one of
    ``k`` concurrent movers: the slower of the source read floor and the
    destination fair-share write time. The simulator reproduces this shape
    dynamically; this closed form serves sizing/benchmark analysis."""
    return max(read_floor_time(src, mb), expected_task_time(dst, k, mb))
