"""Token batches: the port's own copy of the JAX package's
`data/pipeline.py`, with the same numpy arithmetic, so both packages
train on the same batches. (step, shard, n_shards) alone fix a batch, so
a restart or an elastic re-shard replays the same sequence.

  * SyntheticLM: a seeded Zipf-ish token stream;
  * MemmapCorpus: a flat binary token file (`write_corpus`), read in
    batch-sized spans strided by (step, shard).

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


@dataclasses.dataclass(frozen=True)
class MemmapCorpus:
    path: str
    vocab: int
    seq_len: int
    batch: int
    dtype: str = "uint16"

    def _data(self):
        return np.memmap(self.path, dtype=self.dtype, mode="r")

    def n_batches(self) -> int:
        return self._data().shape[0] // (self.batch * (self.seq_len + 1))

    def batch_at(self, step: int, shard: int = 0, n_shards: int = 1):
        """Span (step * n_shards + shard) mod the spans in the file, each
        token taken mod vocab."""
        data = self._data()
        span = self.batch * (self.seq_len + 1)
        n = data.shape[0] // span
        idx = (step * n_shards + shard) % max(n, 1)
        chunk = np.asarray(data[idx * span:(idx + 1) * span], dtype=np.int64)
        chunk = (chunk % self.vocab).reshape(self.batch, self.seq_len + 1)
        tokens = chunk[:, :-1].astype(np.int32)
        labels = chunk[:, 1:].astype(np.int32).copy()
        labels[:, -1] = -1
        return {"tokens": tokens, "labels": labels}


def write_corpus(path: str, tokens: np.ndarray, dtype: str = "uint16"):
    """Write `tokens` as the flat binary file MemmapCorpus reads."""
    np.asarray(tokens, dtype=dtype).tofile(path)


def _mrope_positions(before: int, grid, after: int) -> np.ndarray:
    """(T, 3) (t, h, w) positions of `before` text tokens, one image of
    grid[0] x grid[1] patches, then `after` text tokens, as Qwen2-VL
    places them: text token i at t = h = w = i; the patch in row r,
    column c of an image that starts at p at (p, p + r, p + c); the text
    after it from the largest position so far + 1."""
    gh, gw = grid
    n_img = gh * gw
    pos = np.empty((before + n_img + after, 3), np.int64)
    pos[:before] = np.arange(before)[:, None]
    r, c = np.divmod(np.arange(n_img), gw)
    pos[before:before + n_img] = np.stack(
        [np.full(n_img, before), before + r, before + c], axis=1)
    nxt = before + max(gh, gw)
    pos[before + n_img:] = (nxt + np.arange(after))[:, None]
    return pos


def multimodal_prompt(rng, vocab: int, d_model: int, *, batch: int = 1,
                      before: int = 8, grid=(16, 16), after: int = 8,
                      scale: float = 0.02):
    """A vlm prompt of `before` text tokens, one image of grid[0] x
    grid[1] patches, then `after` text tokens, as numpy arrays:
    {"tokens": (B, T) int32, "patch_embeds": (B, T, d_model) f32 (normal
    x scale at the patches, zeros at text), "positions": (B, T, 3)
    int32} (`_mrope_positions`)."""
    gh, gw = grid
    n_img = gh * gw
    t = before + n_img + after
    tokens = rng.integers(0, vocab, (batch, t)).astype(np.int32)
    embeds = np.zeros((batch, t, d_model), np.float32)
    embeds[:, before:before + n_img] = rng.standard_normal(
        (batch, n_img, d_model)) * scale
    positions = np.broadcast_to(_mrope_positions(before, grid, after),
                                (batch, t, 3)).astype(np.int32)
    return {"tokens": tokens, "patch_embeds": embeds,
            "positions": np.ascontiguousarray(positions)}


def with_image(batch, rng, d_model: int, *, at: int, grid=(16, 16),
               scale: float = 0.02):
    """A vlm training batch from a text batch {"tokens", "labels"} (B, T):
    every row gets one image of grid[0] x grid[1] patches at positions
    [at, at + gh * gw), in `multimodal_prompt`'s layout: "patch_embeds"
    (B, T, d_model) f32, normal x scale at the patches and zeros at text,
    (B, T, 3) int32 "positions", and labels -1 at the patches (their
    tokens are placeholders, not text to predict)."""
    b, t = batch["tokens"].shape
    n_img = grid[0] * grid[1]
    if at + n_img > t:
        raise ValueError(f"an image of {n_img} patches at {at} does not "
                         f"fit {t} tokens")
    embeds = np.zeros((b, t, d_model), np.float32)
    embeds[:, at:at + n_img] = rng.standard_normal((b, n_img, d_model)) \
        * scale
    positions = np.broadcast_to(
        _mrope_positions(at, grid, t - at - n_img), (b, t, 3))
    labels = np.array(batch["labels"], copy=True)
    labels[:, at:at + n_img] = -1
    return dict(batch, labels=labels, patch_embeds=embeds,
                positions=np.ascontiguousarray(positions, np.int32))
