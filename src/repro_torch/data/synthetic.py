"""Deterministic synthetic token pipeline.

A copy of the JAX package's ``repro/data/synthetic.py`` generator (numpy
only): for one ``seed`` and host id its batches are the reference's bit for
bit.  The stream is a seeded Markov-ish mixture so the LM loss actually
decreases (pure-uniform tokens would have irreducible loss = log V): token t
is a deterministic function of token t-1 with probability ``structure``,
else fresh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    batch_size: int          # per-host batch
    seed: int = 0
    structure: float = 0.75  # P(next token is a deterministic successor)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._succ = rng.permutation(self.vocab_size)

    def batches(self, host_id: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """``{"tokens", "labels"}`` int32 [batch, seq_len] numpy batches,
        labels the tokens shifted by one."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, host_id]))
        while True:
            fresh = rng.integers(0, self.vocab_size,
                                 size=(self.batch_size, self.seq_len + 1))
            keep = rng.random((self.batch_size, self.seq_len + 1)) \
                < self.structure
            toks = fresh.copy()
            for t in range(1, self.seq_len + 1):
                toks[:, t] = np.where(keep[:, t],
                                      self._succ[toks[:, t - 1]],
                                      fresh[:, t])
            yield {
                "tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32),
            }
