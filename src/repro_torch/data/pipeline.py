"""Synthetic token batches: the port's own copy of `SyntheticLM` from the
JAX package's `data/pipeline.py`, with the same numpy draws, so both
packages train on the same batches. (`MemmapCorpus` is not ported yet.)

`batch_at(step)` yields {"tokens": (B, S), "labels": (B, S)} int32 numpy
arrays, labels = tokens shifted left, the last label -1 (no label).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    seq_len: int
    batch: int                 # per-host batch
    seed: int = 0
    zipf_a: float = 1.2

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1):
        """(step, shard) alone fix the batch: a restart reproduces it."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard, n_shards]))
        # Zipf-distributed ids clipped to vocab: realistic token skew
        toks = rng.zipf(self.zipf_a, size=(self.batch, self.seq_len + 1))
        toks = (toks - 1) % self.vocab
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32).copy()
        labels[:, -1] = -1
        return {"tokens": tokens, "labels": labels}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
