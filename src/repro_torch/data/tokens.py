"""Deterministic synthetic token pipeline (LM training substrate): a copy
of the reference's ``data/tokens.py``, pure numpy.

Sharded, resumable, seedable: batch i of worker w is a pure function of
(seed, step, w), so a restart needs only the step cursor. Tokens follow
Zipf-like marginals with a little sequential structure, so losses are
non-degenerate.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TokenPipeline:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    n_workers: int = 1
    worker: int = 0

    def batch_at(self, step: int):
        """Return (tokens, labels) int32 [batch/n_workers, seq_len]."""
        b = self.batch // self.n_workers
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + self.worker)
        u = rng.random((b, self.seq_len + 1))
        base = np.minimum((self.vocab ** u).astype(np.int64), self.vocab - 1)
        shift = rng.integers(0, 7, size=(b, 1))
        toks = (base + np.cumsum(shift * (u > 0.83), axis=1)
                .astype(np.int64)) % self.vocab
        return (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32))

    def state(self, step: int) -> dict:
        return {"seed": self.seed, "step": step, "n_workers": self.n_workers}

    @classmethod
    def resume(cls, vocab, batch, seq_len, state: dict, worker: int = 0,
               n_workers: int | None = None):
        return cls(vocab=vocab, batch=batch, seq_len=seq_len,
                   seed=state["seed"],
                   n_workers=n_workers or state["n_workers"], worker=worker)
