"""Synthetic serving traces: mixed-length prompts of random tokens, and
prefix-heavy chat (one shared system prompt).

Each draws from its numpy Generator in the same order as the JAX
package's trace of the same name (`repro/serving/workload.py`, whose
priority draw is kept), so one seed gives both packages the same
requests.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np


class TraceItem(NamedTuple):
    prompt: np.ndarray
    gen: int
    arrival: float


def _arrivals(rng: np.random.Generator, n: int,
              arrival_rate: float) -> np.ndarray:
    """Poisson arrivals at `arrival_rate` req/s; all at t=0 when 0."""
    if arrival_rate <= 0:
        return np.zeros(n)
    return np.cumsum(rng.exponential(1.0 / arrival_rate, n))


def _make_trace(n: int, rng: np.random.Generator, prompt_fn, gen: int,
                arrival_rate: float) -> List[TraceItem]:
    arrivals = _arrivals(rng, n, arrival_rate)
    rng.integers(0, 1, n)            # the reference's (single) priority level
    return [TraceItem(np.asarray(prompt_fn(i), np.int32), int(gen),
                      float(arrivals[i]))
            for i in range(n)]


def synthetic_trace(cfg, n: int, *, rng: np.random.Generator,
                    len_range: Tuple[int, int] = (8, 48), gen: int = 16,
                    arrival_rate: float = 0.0) -> List[TraceItem]:
    """n requests, prompt lengths uniform over the INCLUSIVE len_range."""
    lo, hi = len_range
    if not 1 <= lo <= hi:
        raise ValueError(f"bad len_range {len_range}")
    lens = rng.integers(lo, hi + 1, n)
    return _make_trace(n, rng,
                       lambda i: rng.integers(0, cfg.vocab, int(lens[i])),
                       gen, arrival_rate)


def prefix_heavy_trace(cfg, n: int, *, rng: np.random.Generator,
                       prefix_len: int = 32,
                       suffix_range: Tuple[int, int] = (2, 12),
                       gen: int = 8,
                       arrival_rate: float = 0.0) -> List[TraceItem]:
    """n requests sharing one `prefix_len`-token system prompt, each with
    a random suffix of a length uniform over the INCLUSIVE suffix_range
    (lo may be 0: identical prompts, the copy-on-write worst case)."""
    lo, hi = suffix_range
    if not 0 <= lo <= hi:
        raise ValueError(f"bad suffix_range {suffix_range}")
    if prefix_len < 1:
        raise ValueError(f"prefix_len must be >= 1, got {prefix_len}")
    prefix = rng.integers(0, cfg.vocab, prefix_len).astype(np.int32)
    lens = rng.integers(lo, hi + 1, n)
    return _make_trace(
        n, rng,
        lambda i: np.concatenate(
            [prefix, rng.integers(0, cfg.vocab, int(lens[i])).astype(np.int32)]),
        gen, arrival_rate)
