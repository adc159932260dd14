"""A family's decode step replayed from a CUDA graph on the card, so that
the host issues one launch for all of a step's kernels (thousands at full
depth) and the device, not the host, sets the pace.

A family hands ``decode_step`` its step as issued op by op, which updates
the state's caches in place, and two functions: ``caches(state)``, the
state's cache tensors in a fixed order, and ``rebuild(tensors, pos)``, a
state of those tensors at ``pos``. The rules:

- Off the card, or for a DTensor state, every step runs as issued.
- A shape's first step runs as issued (it loads the step's kernels and
  libraries); its second is captured over fixed buffers: the caches of the
  state it was given, the tokens and a (1,) int64 device position, which
  the step may read as its ``pos``; every later step replays the graph.
- Graphs are keyed by device, token shape and cache shapes, held per
  parameter module (they go with it) and share one memory pool.
- A step on another state (the next prompt's prefill) first copies that
  state's caches into the buffers. The state a step returns holds the
  buffers, so pass that on, as every caller does. A state whose caches are
  the buffers but that a later state's steps have overwritten is refused.
- The returned logits are a copy: a replay of another graph of the pool may
  overwrite the graph's own output.
"""
from __future__ import annotations

import weakref

import torch
from torch.distributed.tensor import DTensor

#: how often the replay engaged since the counts were last set to 0: steps
#: captured, steps replayed, and states copied into a graph's buffers
counts = {"captures": 0, "replays": 0, "copies": 0}

#: each parameter module's replayed decode steps, by shape: False after the
#: first step at a shape, a ``_Replay`` from the second; they go with the module
_REPLAYS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


class _Replay:
    """One decode step at one shape, captured as a CUDA graph."""

    def __init__(self, step, rebuild, params, cfg, bufs, tokens, pool):
        self.rebuild = rebuild
        self.bufs = bufs
        self.tokens = tokens.clone()
        self.pos = torch.zeros(1, dtype=torch.int64, device=tokens.device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
            self.logits, _ = step(params, cfg, rebuild(bufs, self.pos), self.tokens)
        counts["captures"] += 1

    def __call__(self, given, pos, tokens):
        if any(t is not b for t, b in zip(given, self.bufs)):
            if any(t.data_ptr() == b.data_ptr() for t, b in zip(given, self.bufs)):
                raise RuntimeError("decode_step: a later state's steps have overwritten this "
                                   "state's caches (on the card one state a shape steps at a time)")
            for b, t in zip(self.bufs, given):
                b.copy_(t)
            # new tensor objects over the same memory: a state built on the old
            # ones is now stale, and refused above
            self.bufs = [b.detach() for b in self.bufs]
            counts["copies"] += 1
        self.pos.fill_(pos)
        self.tokens.copy_(tokens)
        self.graph.replay()
        counts["replays"] += 1
        return self.logits.clone(), self.rebuild(self.bufs, pos + 1)


def replayable(tokens, tensors) -> bool:
    """Whether a step on ``tokens`` over the caches ``tensors`` may be
    replayed: on the card, and no cache a DTensor."""
    return tokens.is_cuda and not any(isinstance(t, DTensor) for t in tensors)


def decode_step(step, caches, rebuild, params, cfg, state, tokens):
    """``step(params, cfg, state, tokens)`` (-> (logits, new state)), replayed
    on the card by the rules above; ``state.pos`` an int."""
    given = caches(state)
    if not replayable(tokens, given):
        return step(params, cfg, state, tokens)
    replays = _REPLAYS.setdefault(params, {})
    key = (tokens.device, tuple(tokens.shape), *(tuple(t.shape) for t in given))
    r = replays.get(key)
    if r is None:
        replays[key] = False
        return step(params, cfg, state, tokens)
    if r is False:
        pool = next((x.graph.pool() for x in replays.values() if x), None)
        r = replays[key] = _Replay(step, rebuild, params, cfg, list(given), tokens, pool)
    return r(given, state.pos, tokens)
