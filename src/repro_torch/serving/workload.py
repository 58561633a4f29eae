"""Synthetic serving trace: mixed-length prompts of random tokens.

`synthetic_trace` draws from its numpy Generator in the same order as
the JAX package's (`repro/serving/workload.py`, whose priority draw is
kept), so one seed gives both packages the same requests.
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


def synthetic_trace(cfg, n: int, *, rng: np.random.Generator,
                    len_range: Tuple[int, int] = (8, 48), gen: int = 16,
                    arrival_rate: float = 0.0) -> List[TraceItem]:
    """n requests, prompt lengths uniform over the INCLUSIVE len_range."""
    lo, hi = len_range
    if not 1 <= lo <= hi:
        raise ValueError(f"bad len_range {len_range}")
    lens = rng.integers(lo, hi + 1, n)
    arrivals = _arrivals(rng, n, arrival_rate)
    rng.integers(0, 1, n)            # the reference's (single) priority level
    return [TraceItem(rng.integers(0, cfg.vocab, int(lens[i])).astype(np.int32),
                      int(gen), float(arrivals[i]))
            for i in range(n)]
