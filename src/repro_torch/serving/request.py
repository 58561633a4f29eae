"""Request lifecycle and per-request stats (the JAX package's
`repro/serving/request.py`). An encdec request carries its encoder
frames, (enc_ctx, d_model), the stub conv frontend's output.

A request moves WAITING -> ACTIVE -> FINISHED on the happy path. While
ACTIVE it owns one cache slot (a batch row of the engine's KV cache or
recurrent state); on its end the slot is released and the next waiting
request is admitted into it while the other slots keep decoding.

The other edges:

  * EXPIRED      - a waiter whose `deadline` passed before admission is
                   dropped by the scheduler and never takes a slot.
  * CANCELLED    - `engine.cancel(rid)` ended the request (waiting or
                   mid-decode); its slot and KV pages are freed at once.
  * QUARANTINED  - its logits row was not all finite; `error` says
                   where. Only this request ends.
  * preemption   - ACTIVE -> WAITING: the engine took the slot and its
                   pages for a higher-priority head. On resume the
                   context (prompt + generated so far) is recomputed and
                   generation goes on where it stopped.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

WAITING = "waiting"
ACTIVE = "active"
FINISHED = "finished"
EXPIRED = "expired"
CANCELLED = "cancelled"
QUARANTINED = "quarantined"

#: States a request can end in (slot and pages released for good).
TERMINAL = (FINISHED, EXPIRED, CANCELLED, QUARANTINED)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int
    arrival_time: float = 0.0          # seconds on the engine clock
    deadline: Optional[float] = None   # absolute engine-clock seconds
    priority: int = 0                  # higher = more important
    enc_frames: Optional[np.ndarray] = None   # encdec: (enc_ctx, d_model)

    # engine-owned state
    status: str = WAITING
    slot: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    preemptions: int = 0               # times this request lost its slot
    resume_at: float = 0.0             # earliest re-admission (backoff)
    error: Optional[str] = None        # diagnostic for quarantined/failed
    draft_proposed: int = 0            # speculative tokens proposed for
    draft_accepted: int = 0            # ... / accepted on this request
    verify_dropped: int = 0            # moe: expert assignments of its
                                       # real verify rows dropped

    @property
    def acceptance_rate(self) -> Optional[float]:
        """Fraction of draft proposals the target accepted (None when
        the engine ran without speculation)."""
        if self.draft_proposed == 0:
            return None
        return self.draft_accepted / self.draft_proposed

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 1, got "
                f"{self.max_new_tokens}")
        if self.deadline is not None and self.deadline < self.arrival_time:
            raise ValueError(
                f"request {self.rid}: deadline {self.deadline} precedes "
                f"arrival_time {self.arrival_time}")

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def n_generated(self) -> int:
        return len(self.generated)

    @property
    def remaining_tokens(self) -> int:
        """Tokens still to generate (less than max_new_tokens after a
        preemption resumed a partially-decoded request)."""
        return max(0, self.max_new_tokens - self.n_generated)

    def context_tokens(self) -> np.ndarray:
        """Prompt plus everything generated so far: the context a resume
        recomputes so that decode goes on where it stopped."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    @property
    def ttft(self) -> Optional[float]:
        """Time-to-first-token (admission prefill completes)."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival_time

    @property
    def latency(self) -> Optional[float]:
        if self.t_finished is None:
            return None
        return self.t_finished - self.arrival_time

    @property
    def missed_deadline(self) -> Optional[bool]:
        """True/False once terminal and a deadline was set, else None."""
        if self.deadline is None or self.status not in TERMINAL:
            return None
        if self.status != FINISHED:
            return True
        return self.t_finished > self.deadline


def percentile(values, q: float) -> float:
    vals = [v for v in values if v is not None]
    if not vals:
        return float("nan")
    return float(np.percentile(np.asarray(vals, np.float64), q))
