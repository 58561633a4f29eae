"""Synthetic token batches: the port's own copy of `SyntheticLM` from the
JAX package's `data/pipeline.py`, with the same numpy draws, so both
packages train on the same batches. (`MemmapCorpus` is not ported yet.)

`batch_at(step)` yields {"tokens": (B, S), "labels": (B, S)} int32 numpy
arrays, labels = tokens shifted left, the last label -1 (no label).

`multimodal_prompt` lays out a vlm prompt (text, an image's patches,
text) as the stub vision frontend of both packages hands it over: patch
embeddings aligned with the tokens and Qwen2-VL's (t, h, w) positions.
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


def multimodal_prompt(rng, vocab: int, d_model: int, *, batch: int = 1,
                      before: int = 8, grid=(16, 16), after: int = 8,
                      scale: float = 0.02):
    """A vlm prompt of `before` text tokens, one image of grid[0] x
    grid[1] patches, then `after` text tokens, as numpy arrays:
    {"tokens": (B, T) int32, "patch_embeds": (B, T, d_model) f32 (normal
    x scale at the patches, zeros at text), "positions": (B, T, 3)
    int32}. Qwen2-VL's positions: text token i at t = h = w = i; the
    patch in row r, column c of an image that starts at p at (p, p + r,
    p + c); the text after it from the largest position so far + 1."""
    gh, gw = grid
    n_img = gh * gw
    t = before + n_img + after
    tokens = rng.integers(0, vocab, (batch, t)).astype(np.int32)
    embeds = np.zeros((batch, t, d_model), np.float32)
    embeds[:, before:before + n_img] = rng.standard_normal(
        (batch, n_img, d_model)) * scale
    pos = np.empty((t, 3), np.int64)
    pos[:before] = np.arange(before)[:, None]
    r, c = np.divmod(np.arange(n_img), gw)
    pos[before:before + n_img] = np.stack(
        [np.full(n_img, before), before + r, before + c], axis=1)
    nxt = before + max(gh, gw)
    pos[before + n_img:] = (nxt + np.arange(after))[:, None]
    positions = np.broadcast_to(pos, (batch, t, 3)).astype(np.int32)
    return {"tokens": tokens, "patch_embeds": embeds,
            "positions": np.ascontiguousarray(positions)}
