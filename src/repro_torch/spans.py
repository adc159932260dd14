"""Spans at the port's layer boundaries: ``span(name, **attrs)``, a context
manager (or decorator) that writes to whichever of two sinks is on.

* The ambient ``IORuntime``'s ``TraceRecorder``, when that runtime has one
  and runs on a ``RealBackend``: one ``span`` event through
  ``TraceRecorder.span``, its ``cat`` the layer (the name's first dotted
  part), its ``args`` the span's ``id``, the ``parent`` id of the program
  span it nests in on this thread (or None) and the attrs. A simulated
  runtime's clock is virtual, so it gets no events and its trace stays
  byte-identical run to run.
* The torch profiler, while it runs: a host-only range of the same name
  (``RecordFunctionFast``, filed as a ``cpu_op``, with no device-side twin
  as ``record_function``'s ``user_annotation`` has), on the device trace's
  own clock.

Before the first span a recorder gets, the helper records a zero-length
``clock`` anchor (``cat`` ``clock``) whose args hold ``time_ns`` (the
profiler's clock) and ``monotonic_ns`` (``time.perf_counter``'s on Linux)
read at one recorder instant ``t``: a recorder time ``u`` lies at
``time_ns + (u - t) * 1e9`` on the profiler's clock.

With neither sink on, a span costs two checks and records nothing. The
body may add attrs to the dict the ``with`` yields. The names, and what
reads each: docs/torch_spans.md.
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref
from contextlib import contextmanager, nullcontext

import torch

from .core import RealBackend, current_runtime

_profiling = torch._C._autograd._profiler_enabled
_host_range = torch._C._profiler._RecordFunctionFast
_ids = itertools.count(1)
_anchored = weakref.WeakSet()    # recorders that hold their clock anchor
_anchor_lock = threading.Lock()


class _Open(threading.local):
    def __init__(self):
        self.ids = []            # this thread's open recorder spans, innermost last


_open = _Open()


def _recorder():
    rt = current_runtime()
    rec = getattr(rt, "recorder", None)
    return rec if rec is not None and isinstance(rt.backend, RealBackend) else None


def _anchor(rec) -> None:
    with _anchor_lock:
        if rec in _anchored:
            return
        _anchored.add(rec)
        t = rec.now()
        rec.span("clock", "clock", t, t, time_ns=time.time_ns(),
                 monotonic_ns=time.monotonic_ns())


@contextmanager
def span(name: str, **attrs):
    rec = _recorder()
    profiling = _profiling()
    if rec is None and not profiling:
        yield attrs
        return
    if rec is not None:
        _anchor(rec)
        ids = _open.ids
        sid, parent = next(_ids), (ids[-1] if ids else None)
        ids.append(sid)
        t0 = rec.now()
    try:
        with _host_range(name) if profiling else nullcontext():
            yield attrs
    finally:
        if rec is not None:
            t1 = rec.now()
            ids.pop()
            rec.span(name, name.split(".")[0], t0, t1, id=sid, parent=parent, **attrs)
