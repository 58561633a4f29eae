"""Deterministic fault injection for the serving engine (the JAX
package's `repro/serving/faults.py`, with its semantics).

Modeled on `distributed.fault_tolerance.FailureInjector` (scripted by
step count, fire-once), aimed at the serving failure modes: poisoned
logits rows, corrupted KV pages, kernel-level faults, slow steps and a
pool that looks exhausted. Every fault fires at a scripted decode step
or admission ordinal, so a recovery path is pinned by a deterministic
test; the injector reads no clock and no RNG.

Hooks (the engine calls them, see serving/engine.py):

  `poison_rows(step, rows, slots)`   NaN the scripted slots' logits rows
                                     after the device step: the numeric
                                     sentinel must quarantine exactly
                                     those slots.
  `corrupt_slots(step, slots)`       the active slots whose private cache
                                     page the engine NaN-poisons before
                                     the step (the fault then surfaces
                                     through real attention math).
  `before_kernel(step)`              raises SimulatedKernelFault at
                                     scripted steps (the retry and
                                     rebuild path) and sleeps at scripted
                                     slow steps (straggler flagging).
  `deny_admission(ordinal)`          True at scripted admission ordinals:
                                     the engine takes the KV pool as
                                     exhausted, so the preempt-or-defer
                                     path runs without a tight pool.

Each scripted entry fires at most once, so a retried step succeeds and
what a test sees is the recovery, not the fault.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

__all__ = ["FaultInjector", "SimulatedKernelFault"]


class SimulatedKernelFault(RuntimeError):
    """An injected stand-in for a kernel-level failure (a launch error,
    device memory exhausted, a faulting tile) raised by the decode
    step."""


def _as_slot_map(spec) -> Dict[int, Tuple[int, ...]]:
    """{step: slot | (slots...)} as {step: (slots...)}."""
    out: Dict[int, Tuple[int, ...]] = {}
    for step, slots in dict(spec or {}).items():
        if isinstance(slots, (int, np.integer)):
            slots = (int(slots),)
        out[int(step)] = tuple(int(s) for s in slots)
    return out


@dataclasses.dataclass
class FaultInjector:
    """Scripted serving faults. Every schedule keys on the engine's
    decode step counter (from 0) but `deny_admissions`, which keys on
    the admission ordinal (the count of admissions so far, from 0)."""

    nan_rows: Mapping[int, object] = dataclasses.field(default_factory=dict)
    corrupt_pages: Mapping[int, object] = dataclasses.field(
        default_factory=dict)
    kernel_fail_steps: Sequence[int] = ()
    slow_steps: Mapping[int, float] = dataclasses.field(default_factory=dict)
    deny_admissions: Sequence[int] = ()

    def __post_init__(self):
        self.nan_rows = _as_slot_map(self.nan_rows)
        self.corrupt_pages = _as_slot_map(self.corrupt_pages)
        self.kernel_fail_steps = tuple(int(s) for s in self.kernel_fail_steps)
        self.slow_steps = {int(k): float(v)
                           for k, v in dict(self.slow_steps).items()}
        self.deny_admissions = tuple(int(a) for a in self.deny_admissions)
        self._fired: set = set()
        self.counts = {"nan_rows": 0, "page_corruptions": 0,
                       "kernel_faults": 0, "slow_steps": 0,
                       "denied_admissions": 0}

    def _fire(self, key) -> bool:
        if key in self._fired:
            return False
        self._fired.add(key)
        return True

    # -- hooks ----------------------------------------------------------
    def poison_rows(self, step: int, rows: np.ndarray,
                    slots: Sequence[int]) -> np.ndarray:
        """NaN the scripted slots' logits rows at `step`. Returns `rows`
        itself when nothing is scripted, else a poisoned copy."""
        todo = [s for s in self.nan_rows.get(step, ())
                if s in slots and ("nan", step, s) not in self._fired]
        if not todo:
            return rows
        rows = np.array(rows)
        for slot in todo:
            self._fire(("nan", step, slot))
            rows[slot] = np.nan
            self.counts["nan_rows"] += 1
        return rows

    def corrupt_slots(self, step: int,
                      slots: Sequence[int]) -> Tuple[int, ...]:
        """The active slots whose cache page the engine poisons before
        decode step `step`."""
        hit = []
        for slot in self.corrupt_pages.get(step, ()):
            if slot in slots and self._fire(("page", step, slot)):
                hit.append(slot)
                self.counts["page_corruptions"] += 1
        return tuple(hit)

    def before_kernel(self, step: int) -> None:
        """Called just before the decode step runs."""
        if step in self.slow_steps and self._fire(("slow", step)):
            self.counts["slow_steps"] += 1
            time.sleep(self.slow_steps[step])
        if step in self.kernel_fail_steps and self._fire(("kernel", step)):
            self.counts["kernel_faults"] += 1
            raise SimulatedKernelFault(
                f"injected kernel fault at decode step {step}")

    def deny_admission(self, ordinal: int) -> bool:
        """True when admission `ordinal` is scripted to see an exhausted
        pool (once an ordinal)."""
        if ordinal in self.deny_admissions and self._fire(("deny", ordinal)):
            self.counts["denied_admissions"] += 1
            return True
        return False

    # -- report ---------------------------------------------------------
    def report(self) -> Dict[str, int]:
        return dict(self.counts)
