"""Request lifecycle and per-request stats.

A request moves WAITING -> ACTIVE -> FINISHED. While ACTIVE it owns one
cache slot (a batch row of the engine's KV cache); on finish the slot
is released and the next waiting request is admitted into it while the
other slots keep decoding.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

WAITING = "waiting"
ACTIVE = "active"
FINISHED = "finished"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int
    arrival_time: float = 0.0          # seconds on the engine clock

    # engine-owned state
    status: str = WAITING
    slot: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 1, got "
                f"{self.max_new_tokens}")

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (the admission prefill completes)."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival_time

    @property
    def latency(self) -> Optional[float]:
        if self.t_finished is None:
            return None
        return self.t_finished - self.arrival_time


def percentile(values, q: float) -> float:
    vals = [v for v in values if v is not None]
    if not vals:
        return float("nan")
    return float(np.percentile(np.asarray(vals, np.float64), q))
