"""The seeded synthetic corpus, a frozen copy of ``repro_torch.data``'s
``SyntheticCorpus`` (numpy only). The train cells feed it to the port's
``PrefetchLoader``, which only calls ``batch(step)``."""
from __future__ import annotations

import numpy as np


class SyntheticCorpus:
    """``batch(step)`` is a pure function of (seed, step): every row starts
    at a random token and follows a learnable affine next-token rule, with a
    share ``noise`` of the tokens replaced at random, so rows all differ."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int, seed: int,
                 noise: float = 0.1):
        self.vocab, self.seq, self.local_batch = vocab_size, seq_len, batch
        self.seed, self.noise = seed, noise

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0, step]))
        B, S, V = self.local_batch, self.seq + 1, self.vocab
        toks = np.empty((B, S), dtype=np.int32)
        toks[:, 0] = rng.integers(0, V, size=B)
        for i in range(1, S):
            toks[:, i] = (toks[:, i - 1] * 31 + 7) % V
        corrupt = rng.random((B, S)) < self.noise
        toks[corrupt] = rng.integers(0, V, size=int(corrupt.sum()))
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
