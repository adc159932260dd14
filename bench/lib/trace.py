"""Host spans and the device trace of a traced region.

Spans are the benchmark's own: it times the calls it makes into each layer
of the program (a train step, a save, a prefill, a decode step) on the host
clock, after the call's result is on the host. The device trace comes from
``torch.profiler`` over a region of the run that the cell's traffic file
names, each iteration in it marked by a ``record_function`` range named
``bench.<what>[:<shape>]``; every iteration ends on a device sync, so the
kernels that start inside a mark are that iteration's.

``busy_ms`` is a copy of ``scripts/profile_serve_torch.py``'s.
"""
from __future__ import annotations

import bisect
import time
from contextlib import contextmanager


class Spans:
    """``(name, t0, t1, attrs)`` on ``time.perf_counter``'s clock."""

    def __init__(self):
        self.rows: list[dict] = []

    @contextmanager
    def span(self, name: str, **attrs):
        row = {"name": name, "t0": time.perf_counter(), **attrs}
        try:
            yield row
        finally:
            row["t1"] = time.perf_counter()
            self.rows.append(row)

    def of(self, name: str) -> list[dict]:
        return [r for r in self.rows if r["name"] == name]


def busy_ms(intervals):
    """Length of the union of (start, end) intervals, in ms (inputs in us)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class DeviceTrace:
    """What the reduction keeps of one profiled region (times in us, on the
    profiler's clock): ``kernels`` [(name, start, end)], ``marks`` [(name,
    start, end)] of the ``bench.*`` ranges, ``host_ops`` [(name, start, end)]
    of every other host-side event, sorted by start; ``t0``/``t1`` the
    region, from the first mark's start to the last mark's end."""

    def __init__(self, kernels, marks, host_ops):
        self.kernels = sorted(kernels, key=lambda k: k[1])
        self.marks = sorted(marks, key=lambda m: m[1])
        self.host_ops = sorted(host_ops, key=lambda h: h[1])
        self._starts = [k[1] for k in self.kernels]
        self.t0 = self.marks[0][1] if self.marks else 0.0
        self.t1 = self.marks[-1][2] if self.marks else 0.0

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return busy_ms([(s, e) for _, s, e in self.kernels if s < self.t1 and e > self.t0]) / 1e3

    def marks_named(self, prefix: str):
        return [m for m in self.marks if m[0] == prefix or m[0].startswith(prefix + ":")]

    def kernels_in(self, mark):
        """Kernels that start inside ``mark``."""
        lo = bisect.bisect_left(self._starts, mark[1])
        hi = bisect.bisect_right(self._starts, mark[2])
        return self.kernels[lo:hi]

    def device_ops(self, top: int = 10):
        """[[kernel name, seconds]] of the kernels that took most device time."""
        by: dict = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[n[:120], t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, min_us: float = 20.0):
        """[[host activity, seconds]]: the device's idle time inside the region,
        each gap of ``min_us`` or more put under what the host was doing when
        it began (the innermost host event open then, under its mark), the
        shorter ones together; the activities with the most idle time."""
        busy = _union([(max(s, self.t0), min(e, self.t1)) for _, s, e in self.kernels
                       if s < self.t1 and e > self.t0])
        gaps, prev = [], self.t0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        starts = [h[1] for h in self.host_ops]
        mark_starts = [m[1] for m in self.marks]
        by: dict = {}
        for g0, g1 in gaps:
            if g1 - g0 < min_us:
                label = f"gaps under {min_us:g} us"
            else:
                label = self._innermost(starts, g0) or "host between ops"
                i = bisect.bisect_right(mark_starts, g0) - 1
                if i >= 0 and self.marks[i][2] >= g0:
                    label = f"{self.marks[i][0].split(':')[0]} / {label}"
            by[label] = by.get(label, 0.0) + (g1 - g0) / 1e6
        return [[n[:120], t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def _innermost(self, starts, t, look_back: int = 400):
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - look_back), -1):
            name, s, e = self.host_ops[j]
            if e >= t:
                return name
        return None


@contextmanager
def profiled(torch, out: list):
    """Profile the block (host and device); appends its ``DeviceTrace`` to
    ``out`` once the block has ended and the device is idle. Reads the
    profiler's raw events (building its event tree would take minutes for a
    region of a few hundred thousand kernels): every event on the device is
    an operation (a kernel, copy or fill) except the device-side twins of
    the ``bench.*`` marks."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU]
                 + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        yield
        sync()
    on_device = torch.autograd.DeviceType.CUDA
    kernels, marks, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns() / 1e3
        row = (name, s, s + e.duration_ns() / 1e3)
        if e.device_type() == on_device:
            if not name.startswith("bench."):
                kernels.append(row)
        elif name.startswith("bench."):
            marks.append(row)
        else:
            host.append(row)
    out.append(DeviceTrace(kernels, marks, host))


def warm_profiler(torch):
    """One empty profiled region, so that the profiler's own start-up is paid
    in set-up and not in the traced region."""
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
