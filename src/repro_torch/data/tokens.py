"""Synthetic token streams for LM training/serving examples (counterpart
of ``repro.data.tokens``, the same numpy code, so its batches equal
``repro``'s bit for bit).

A deterministic order-2 Markov source: learnable structure so small LMs show
real loss reduction (used by the train launcher and the serving demos).
"""
from __future__ import annotations

import numpy as np


class MarkovTokenSource:
    def __init__(self, vocab_size: int, seed: int = 0, branching: int = 4,
                 num_contexts: int = 128):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        # each context-hash allows `branching` successors
        self.table = rng.integers(0, vocab_size,
                                  (num_contexts, branching)).astype(np.int32)
        self.branching = branching
        self.num_contexts = num_contexts
        self.rng = rng

    def batch(self, batch_size: int, seq_len: int,
              seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        out = np.empty((batch_size, seq_len + 1), np.int32)
        prev1 = rng.integers(0, self.vocab, batch_size)
        prev2 = rng.integers(0, self.vocab, batch_size)
        for t in range(seq_len + 1):
            h = (prev1 * 31 + prev2 * 17) % self.num_contexts
            pick = rng.integers(0, self.branching, batch_size)
            tok = self.table[h, pick]
            out[:, t] = tok
            prev2, prev1 = prev1, tok
        return out

    def train_batch(self, batch_size: int, seq_len: int, seed: int = 0):
        toks = self.batch(batch_size, seq_len, seed)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
