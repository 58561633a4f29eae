"""Continuous-batching serving over dense KV slots (see serving.engine)."""

from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.sampler import greedy
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.workload import TraceItem, synthetic_trace

__all__ = ["ServingEngine", "SlotScheduler", "TraceItem", "greedy",
           "synthetic_trace"]
