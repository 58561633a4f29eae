"""Continuous-batching serving over dense KV slots or a page pool (see
serving.engine)."""

from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.kv_pool import KVPagePool, KVPoolExhausted
from repro_torch.serving.sampler import greedy
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.workload import (TraceItem, prefix_heavy_trace,
                                          synthetic_trace)

__all__ = ["KVPagePool", "KVPoolExhausted", "ServingEngine", "SlotScheduler",
           "TraceItem", "greedy", "prefix_heavy_trace", "synthetic_trace"]
