"""Deterministic synthetic corpus + host-sharded loader with background
prefetch through the I/O-aware runtime (reads are I/O tasks, so batch
preparation overlaps the train step — the paper's reading-task case).
"""
from __future__ import annotations

import numpy as np

from ..core import current_runtime, io, task


class SyntheticCorpus:
    """Stateless, reproducible token stream: batch(step) is a pure function
    of (seed, step, host slice) — restart-safe by construction."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_hosts: int = 1, host_index: int = 0,
                 structured: bool = True, noise: float = 0.1):
        assert global_batch % n_hosts == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // n_hosts
        self.seed = seed
        self.host = host_index
        self.structured = structured  # learnable affine next-token pattern
        self.noise = noise

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.host, step]))
        B, S, V = self.local_batch, self.seq + 1, self.vocab
        if not self.structured:
            toks = rng.integers(0, V, size=(B, S), dtype=np.int32)
        else:
            toks = np.empty((B, S), dtype=np.int32)
            toks[:, 0] = rng.integers(0, V, size=B)
            for i in range(1, S):
                toks[:, i] = (toks[:, i - 1] * 31 + 7) % V
            corrupt = rng.random((B, S)) < self.noise
            toks[corrupt] = rng.integers(0, V, size=int(corrupt.sum()))
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@io
@task(returns=1)
def _fetch_task(corpus, step):
    return corpus.batch(step)


class PrefetchLoader:
    """Issues batch(step+1..step+depth) as I/O tasks while step runs."""

    def __init__(self, corpus: SyntheticCorpus, depth: int = 2):
        self.corpus = corpus
        self.depth = depth
        self._pending: dict[int, object] = {}

    def get(self, step: int) -> dict:
        rt = current_runtime()
        if rt is None:
            return self.corpus.batch(step)
        for s in range(step, step + self.depth + 1):
            if s not in self._pending:
                self._pending[s] = _fetch_task(self.corpus, s)
        fut = self._pending.pop(step)
        return rt.wait_on(fut)
