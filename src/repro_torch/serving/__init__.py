"""Continuous-batching serving (the JAX package's `repro/serving`).

    engine.py     request lifecycle admit -> prefill -> decode -> evict
                  over a fixed pool of cache slots, with deadlines,
                  cancel, priority preemption and quarantine, kernel
                  fault retries and a rebuild of the captured steps,
                  and speculative decoding
    scheduler.py  slot allocation and FCFS admission over eligible
                  waiters (arrival and preemption backoff), deadline
                  expiry, preemption requeue
    kv_pool.py    paged KV layout: page pool and per-slot page tables,
                  content-hashed prefix sharing, copy-on-write
    sampler.py    greedy / temperature / top-k token selection and the
                  speculative leftover/residual acceptance rule
    spec.py       speculative decoding's draft side: per-slot draft KV
                  cache, draft rounds, positional rollback
    steps.py      the weights' placement and the CUDA-graph steps
    request.py    request lifecycle and per-request stats
    workload.py   synthetic traces by name (mixed, prefix_heavy, bursty,
                  long_context), with deadlines and priorities
    faults.py     the deterministic chaos injector (NaN rows, page
                  corruption, kernel faults, slow steps, denied
                  admissions), scripted by step counts
"""

from repro_torch.serving.engine import (DEFAULT_PAGE_SIZE,
                                        DEFAULT_PREFILL_CHUNK, ServingEngine)
from repro_torch.serving.faults import FaultInjector, SimulatedKernelFault
from repro_torch.serving.kv_pool import (AdmitPlan, KVPagePool,
                                         KVPoolExhausted, PageWrite)
from repro_torch.serving.request import Request, percentile
from repro_torch.serving.sampler import (Sampler, SamplerConfig, greedy,
                                         make_sampler, residual_distribution)
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.spec import SpecDecoder
from repro_torch.serving.workload import (TRACES, TraceItem, bursty_trace,
                                          long_context_trace, make_trace,
                                          prefix_heavy_trace, synthetic_trace)

__all__ = [
    "AdmitPlan", "DEFAULT_PAGE_SIZE", "DEFAULT_PREFILL_CHUNK",
    "FaultInjector", "SimulatedKernelFault",
    "KVPagePool", "KVPoolExhausted", "PageWrite",
    "ServingEngine", "SpecDecoder",
    "Request", "percentile",
    "Sampler", "SamplerConfig", "greedy", "make_sampler",
    "residual_distribution",
    "SlotScheduler",
    "TRACES", "TraceItem", "bursty_trace", "long_context_trace",
    "make_trace", "prefix_heavy_trace", "synthetic_trace",
]
