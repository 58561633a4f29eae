"""Slot-level scheduler: a fixed pool of cache slots, FCFS admission.

Pure bookkeeping: which request sits in which slot and who is admitted
next. The engine owns the device tensors (the per-slot `pos` vector and
the batched cache) that mirror these decisions. A waiter is eligible
once it has arrived on the engine clock; a later request never jumps an
eligible head.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from repro_torch.serving.request import ACTIVE, FINISHED, WAITING, Request


class SlotScheduler:
    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = max_slots
        self._free: List[int] = list(range(max_slots - 1, -1, -1))
        self._waiting: deque[Request] = deque()
        self._active: Dict[int, Request] = {}

    def submit(self, req: Request) -> None:
        if req.status != WAITING:
            raise ValueError(
                f"request {req.rid} submitted with status {req.status!r}; "
                f"only {WAITING!r} requests can join the queue")
        if req in self._waiting:
            raise ValueError(f"request {req.rid} is already queued")
        self._waiting.append(req)

    def next_admission(self, now: float) -> Optional[Request]:
        """First arrived waiter in queue order if a slot is free."""
        if not self._free:
            return None
        for req in self._waiting:
            if req.arrival_time <= now:
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
            raise ValueError(f"no free slot to admit request {req.rid} into")
        slot = self._free.pop()
        req.slot = slot
        req.status = ACTIVE
        self._active[slot] = req
        return slot

    def release(self, slot: int, status: str = FINISHED) -> Request:
        """Free an active slot; the departing request gets `status`."""
        if slot not in self._active:
            raise ValueError(f"slot {slot} is not active; cannot release")
        req = self._active.pop(slot)
        req.status = status
        req.slot = -1
        self._free.append(slot)
        return req

    @property
    def active(self) -> Dict[int, Request]:
        return dict(self._active)

    @property
    def n_active(self) -> int:
        return len(self._active)

    @property
    def n_waiting(self) -> int:
        return len(self._waiting)

    def has_work(self) -> bool:
        return bool(self._waiting or self._active)

    def next_arrival_time(self) -> Optional[float]:
        """Earliest arrival among the waiters, or None."""
        if not self._waiting:
            return None
        return min(w.arrival_time for w in self._waiting)
