"""Synthetic serving traces, a registry of scenarios (the JAX package's
`repro/serving/workload.py`).

All scenarios share one body (`_make_trace`: arrivals, priorities,
deadlines, encdec frames) and differ in how each request's prompt and
generation budget are drawn; `TRACES` keys them by name for the serve
CLI's `--workload`:

* ``mixed`` (synthetic_trace): prompt lengths uniform over an INCLUSIVE
  [lo, hi] range, random tokens.
* ``prefix_heavy`` (prefix_heavy_trace): every request opens with the
  SAME `prefix_len`-token system prompt plus a short random suffix.
* ``bursty`` (bursty_trace): compound Poisson arrivals, groups of
  1 + Poisson(burst_mean - 1) simultaneous requests with exponential
  gaps scaled to keep the long-run request rate.
* ``long_context`` (long_context_trace): long prompts, short
  generations.

Each draws from its numpy Generator in the JAX package's order, so one
seed gives both packages the same requests: an encdec request's frames,
(enc_ctx, d_model) normal f32, are drawn right after its prompt, as
there. ``deadline`` is relative to arrival (the TraceItem holds the
absolute engine-clock deadline) and ``priority_levels`` are drawn
uniformly per request. ``enc_frames`` is the TraceItem's last field
(the JAX package's fourth), so positional uses of the others stand.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np


class TraceItem(NamedTuple):
    prompt: np.ndarray
    gen: int
    arrival: float
    deadline: Optional[float] = None       # absolute engine-clock seconds
    priority: int = 0
    enc_frames: Optional[np.ndarray] = None  # encdec: (enc_ctx, d_model)


def _arrivals(rng: np.random.Generator, n: int, arrival_rate: float,
              burst_size: int) -> np.ndarray:
    """Arrival times: Poisson gaps per request, or: with burst_size > 1
   : per *group* of simultaneous requests, gap mean scaled by the
    group size so the long-run request rate is unchanged."""
    if burst_size < 1:
        raise ValueError(f"burst_size must be >= 1, got {burst_size}")
    if arrival_rate <= 0:
        return np.zeros(n)
    if burst_size == 1:
        return np.cumsum(rng.exponential(1.0 / arrival_rate, n))
    n_bursts = -(-n // burst_size)
    times = np.cumsum(rng.exponential(burst_size / arrival_rate, n_bursts))
    return np.repeat(times, burst_size)[:n]


def _compound_arrivals(rng: np.random.Generator, n: int,
                       arrival_rate: float, burst_mean: float) -> np.ndarray:
    """Compound Poisson arrivals: burst sizes 1 + Poisson(burst_mean-1)
    (so the mean group size is burst_mean and no group is empty), each
    group simultaneous, exponential inter-group gaps with mean
    burst_mean / arrival_rate: the long-run REQUEST rate stays
    `arrival_rate` while the instantaneous load swings."""
    if burst_mean < 1:
        raise ValueError(f"burst_mean must be >= 1, got {burst_mean}")
    if arrival_rate <= 0:
        return np.zeros(n)
    out: List[float] = []
    t = 0.0
    while len(out) < n:
        t += float(rng.exponential(burst_mean / arrival_rate))
        size = 1 + int(rng.poisson(burst_mean - 1.0))
        out.extend([t] * size)
    return np.asarray(out[:n])


def _priorities(rng: np.random.Generator, n: int,
                priority_levels: Sequence[int]) -> np.ndarray:
    levels = np.asarray(list(priority_levels), np.int64)
    if levels.size == 0:
        raise ValueError("priority_levels must be non-empty")
    return levels[rng.integers(0, levels.size, n)]


def _make_trace(cfg, n: int, rng: np.random.Generator, prompt_fn, gen,
                *, arrival_rate: float, deadline: Optional[float],
                priority_levels: Sequence[int], burst_size: int = 1,
                arrivals: Optional[np.ndarray] = None) -> List[TraceItem]:
    """The shared trace body: every scenario is `prompt_fn(i) -> prompt`
    plus a per-request generation budget (int, or `gen(i) -> int`) over
    the common arrivals, deadlines, priorities and encdec frames."""
    if arrivals is None:
        arrivals = _arrivals(rng, n, arrival_rate, burst_size)
    prios = _priorities(rng, n, priority_levels)
    gen_fn = gen if callable(gen) else (lambda i: gen)
    trace: List[TraceItem] = []
    for i in range(n):
        prompt = np.asarray(prompt_fn(i), np.int32)
        enc = None
        if cfg.family == "encdec":
            enc = rng.normal(size=(cfg.enc_ctx, cfg.d_model)) \
                .astype(np.float32)
        dl = None if deadline is None else float(arrivals[i]) + deadline
        trace.append(TraceItem(prompt, int(gen_fn(i)), float(arrivals[i]),
                               dl, int(prios[i]), enc))
    return trace


def synthetic_trace(cfg, n: int, *, rng: np.random.Generator,
                    len_range: Tuple[int, int] = (8, 48), gen: int = 16,
                    arrival_rate: float = 0.0,
                    deadline: Optional[float] = None,
                    priority_levels: Sequence[int] = (0,),
                    burst_size: int = 1) -> List[TraceItem]:
    """Mixed-length uniform baseline (registry name: "mixed")."""
    lo, hi = len_range
    if not 1 <= lo <= hi:
        raise ValueError(f"bad len_range {len_range}")
    lens = rng.integers(lo, hi + 1, n)
    return _make_trace(
        cfg, n, rng,
        lambda i: rng.integers(0, cfg.vocab, int(lens[i])), gen,
        arrival_rate=arrival_rate, deadline=deadline,
        priority_levels=priority_levels, burst_size=burst_size)


def prefix_heavy_trace(cfg, n: int, *, rng: np.random.Generator,
                       prefix_len: int = 32,
                       suffix_range: Tuple[int, int] = (2, 12),
                       gen: int = 8,
                       arrival_rate: float = 0.0,
                       deadline: Optional[float] = None,
                       priority_levels: Sequence[int] = (0,),
                       burst_size: int = 1) -> List[TraceItem]:
    """N requests sharing one `prefix_len`-token system prompt, each
    with a uniform [lo, hi] random-token suffix (hi inclusive; lo may be
    0: identical prompts, the copy-on-write worst case)."""
    lo, hi = suffix_range
    if not 0 <= lo <= hi:
        raise ValueError(f"bad suffix_range {suffix_range}")
    if prefix_len < 1:
        raise ValueError(f"prefix_len must be >= 1, got {prefix_len}")
    prefix = rng.integers(0, cfg.vocab, prefix_len).astype(np.int32)
    lens = rng.integers(lo, hi + 1, n)
    return _make_trace(
        cfg, n, rng,
        lambda i: np.concatenate(
            [prefix, rng.integers(0, cfg.vocab, int(lens[i]))
             .astype(np.int32)]), gen,
        arrival_rate=arrival_rate, deadline=deadline,
        priority_levels=priority_levels, burst_size=burst_size)


def bursty_trace(cfg, n: int, *, rng: np.random.Generator,
                 len_range: Tuple[int, int] = (8, 48), gen: int = 16,
                 arrival_rate: float = 0.0, burst_mean: float = 4.0,
                 deadline: Optional[float] = None,
                 priority_levels: Sequence[int] = (0,)) -> List[TraceItem]:
    """Compound-Poisson arrivals (random group sizes, simultaneous
    within a group) over mixed-length prompts: the admission-pressure
    scenario; rate-preserving, so only the VARIANCE differs vs
    "mixed"."""
    lo, hi = len_range
    if not 1 <= lo <= hi:
        raise ValueError(f"bad len_range {len_range}")
    lens = rng.integers(lo, hi + 1, n)
    arrivals = _compound_arrivals(rng, n, arrival_rate, burst_mean)
    return _make_trace(
        cfg, n, rng,
        lambda i: rng.integers(0, cfg.vocab, int(lens[i])), gen,
        arrival_rate=arrival_rate, deadline=deadline,
        priority_levels=priority_levels, arrivals=arrivals)


def long_context_trace(cfg, n: int, *, rng: np.random.Generator,
                       len_range: Tuple[int, int] = (96, 160),
                       gen: int = 4,
                       arrival_rate: float = 0.0,
                       deadline: Optional[float] = None,
                       priority_levels: Sequence[int] = (0,),
                       burst_size: int = 1) -> List[TraceItem]:
    """Long prompts, short generations: prefill-bound traffic (summarize
    / extract shapes). Decode-side machinery matters least here: the
    scenario exists so per-scenario percentiles show WHERE speculation
    and paging pay, not just that they do."""
    lo, hi = len_range
    if not 1 <= lo <= hi:
        raise ValueError(f"bad len_range {len_range}")
    lens = rng.integers(lo, hi + 1, n)
    return _make_trace(
        cfg, n, rng,
        lambda i: rng.integers(0, cfg.vocab, int(lens[i])), gen,
        arrival_rate=arrival_rate, deadline=deadline,
        priority_levels=priority_levels, burst_size=burst_size)


#: Scenario registry: name -> trace builder with the uniform
#: ``(cfg, n, *, rng, **kwargs)`` signature; the serve CLI's
#: ``--workload`` resolves through it.
TRACES: Dict[str, Callable[..., List[TraceItem]]] = {
    "mixed": synthetic_trace,
    "prefix_heavy": prefix_heavy_trace,
    "bursty": bursty_trace,
    "long_context": long_context_trace,
}


def get_trace(name: str) -> Callable[..., List[TraceItem]]:
    try:
        return TRACES[name]
    except KeyError:
        raise ValueError(
            f"unknown workload {name!r}; registered: "
            f"{', '.join(sorted(TRACES))}") from None


def make_trace(name: str, cfg, n: int, *, rng: np.random.Generator,
               **kwargs) -> List[TraceItem]:
    """Build the named scenario's trace (see ``TRACES``)."""
    return get_trace(name)(cfg, n, rng=rng, **kwargs)
