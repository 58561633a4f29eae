"""Slot-level scheduler: fixed pool of cache slots, FCFS admission (the
JAX package's `repro/serving/scheduler.py`).

The scheduler is pure bookkeeping: it owns which request sits in which
slot and who is admitted next; the engine owns the device arrays (the
per-slot `pos` vector and the batched cache) that mirror its decisions.

Admission policy: FCFS over submission order among *eligible* waiters.
A waiter is eligible once it has arrived on the engine clock AND its
preemption-resume backoff (`resume_at`) has elapsed; expired waiters
(deadline passed before admission) are dropped by `drop_expired`
instead of ever occupying a slot. A later request never jumps an
eligible head even if a deeper slot would fit it: the only head-of-
line relaxation is skipping waiters that are not eligible *yet*
(un-arrived, or backing off after a preemption), which is what keeps a
preempted victim from stalling the queue it was evicted to unblock.

Preemption (`preempt`) moves an ACTIVE request back to WAITING, re-
inserted in original submission (rid) order so it does not lose its
place permanently; the engine pairs this with a resume backoff and a
per-request retry budget to bound churn.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from repro_torch.serving.request import ACTIVE, EXPIRED, FINISHED, WAITING, Request


class SlotScheduler:
    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = max_slots
        self._free: List[int] = list(range(max_slots - 1, -1, -1))
        self._waiting: deque[Request] = deque()
        self._active: Dict[int, Request] = {}

    # -- submission ----------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.status != WAITING:
            raise ValueError(
                f"request {req.rid} submitted with status {req.status!r}; "
                f"only {WAITING!r} requests can join the queue")
        if req in self._waiting:
            raise ValueError(f"request {req.rid} is already queued")
        self._waiting.append(req)

    # -- admission -----------------------------------------------------
    def _eligible(self, req: Request, now: float) -> bool:
        return req.arrival_time <= now and req.resume_at <= now

    def next_admission(self, now: float) -> Optional[Request]:
        """First eligible waiter in queue order if a slot is free."""
        if not self._free:
            return None
        for req in self._waiting:
            if self._eligible(req, now):
                return req
        return None

    def admit(self, req: Request) -> int:
        """Bind a waiting request to a free slot; returns the slot id."""
        try:
            self._waiting.remove(req)
        except ValueError:
            raise ValueError(
                f"request {req.rid} is not in the waiting queue "
                f"(status {req.status!r})") from None
        if not self._free:
            raise ValueError(
                f"no free slot to admit request {req.rid} into")
        slot = self._free.pop()
        req.slot = slot
        req.status = ACTIVE
        self._active[slot] = req
        return slot

    def drop_expired(self, now: float) -> List[Request]:
        """Remove waiters whose deadline has already passed; they are
        marked EXPIRED and returned for the engine's accounting."""
        dropped = []
        for req in list(self._waiting):
            if req.deadline is not None and req.deadline < now:
                self._waiting.remove(req)
                req.status = EXPIRED
                dropped.append(req)
        return dropped

    def remove_waiting(self, req: Request) -> None:
        """Take a waiter out of the queue (cancellation)."""
        try:
            self._waiting.remove(req)
        except ValueError:
            raise ValueError(
                f"request {req.rid} is not waiting (status "
                f"{req.status!r})") from None

    # -- release / preemption ------------------------------------------
    def release(self, slot: int, status: str = FINISHED) -> Request:
        """Free an active slot; the departing request gets `status`."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active; cannot release")
        req = self._active.pop(slot)
        req.status = status
        req.slot = -1
        self._free.append(slot)
        return req

    def preempt(self, slot: int, *, resume_at: float = 0.0) -> Request:
        """Evict an active request back to the waiting queue, keeping
        its original submission-order position (rid order) so a resumed
        victim is next in line once its backoff elapses."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active; cannot preempt")
        req = self._active.pop(slot)
        req.status = WAITING
        req.slot = -1
        req.resume_at = resume_at
        self._free.append(slot)
        idx = next((i for i, w in enumerate(self._waiting)
                    if w.rid > req.rid), len(self._waiting))
        self._waiting.insert(idx, req)
        return req

    # -- introspection -------------------------------------------------
    @property
    def active(self) -> Dict[int, Request]:
        return dict(self._active)

    @property
    def n_active(self) -> int:
        return len(self._active)

    @property
    def n_waiting(self) -> int:
        return len(self._waiting)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def has_work(self) -> bool:
        return bool(self._waiting or self._active)

    def next_arrival_time(self) -> Optional[float]:
        """Earliest time any waiter becomes eligible, or None."""
        if not self._waiting:
            return None
        return min(max(w.arrival_time, w.resume_at) for w in self._waiting)
