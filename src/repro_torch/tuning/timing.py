"""The clock the autotuner and `chip_smoke.py`'s kernel tables share.

The port's counterpart of the JAX package's `tuning/timing.py`: the
tuner must score candidate instances with the clock the kernel tables
are built from, or a tuned-against-static speedup would compare two
measurement disciplines. `time_turns` takes the card's time alone, by
CUDA events, the L2 flushed before every call, the candidates run in
turns, and reports each one's median.
"""

from __future__ import annotations

import statistics
import time

import torch

FLUSH_BYTES = 64 << 20                                  # > the 50 MB L2
SLEEP_HZ = 2.0e9              # torch.cuda._sleep cycles a second, at least


def time_turns(fns, *, device, n: int = 50, warmup: int = 3,
               chunk: int = 5) -> list:
    """Median ms of each callable in `fns` over n rounds run in turns
    (fns[0], fns[1], ... in each round), by CUDA events, L2 flushed
    before each (decode reads each weight once a step: the caller finds
    it cold). Only the card's time falls inside an event pair: before
    each chunk of rounds the card sleeps (`torch.cuda._sleep`) for twice
    the host's measured time to enqueue them, so the whole chunk waits in
    the queue when the card wakes, and no wrapper's ctypes call or
    library's Python dispatch is timed. Raises off the card: a plain
    version on the CPU has no tile to time."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"time_turns times the card's kernels; {device} "
                         f"runs their plain versions, which have no tile "
                         f"to time")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for fn in fns:                   # one round, to size the sleep
        flush.zero_()
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    events = [[] for _ in fns]
    for r0 in range(0, n, chunk):
        rounds = min(chunk, n - r0)
        torch.cuda._sleep(int(SLEEP_HZ * (2 * enqueue_s * rounds + 1e-4)))
        for _ in range(rounds):
            for fn, ev in zip(fns, events):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                flush.zero_()
                start.record()
                fn()
                end.record()
                ev.append((start, end))
        torch.cuda.synchronize(device)
    return [statistics.median(s.elapsed_time(e) for s, e in ev)
            for ev in events]
