"""Fault tolerance: supervised training, straggler detection, elastic
mesh shapes; the single-process parts of the JAX package's
`distributed/fault_tolerance.py`, with its semantics.

  * Supervisor.run_resilient: a try/except around each step; on a
    failure, restore the latest checkpoint (in place, into the state's
    own tensors: `checkpoint.Checkpointer.restore`) and go on from its
    step; at most `max_restarts` restarts.
  * StragglerDetector: an EWMA of step times; a step slower than
    `threshold` x the EWMA is flagged and left out of the EWMA.
  * elastic_mesh_shape: the largest (data, model) grid for the devices
    that survive, the model axis kept whole.
  * FailureInjector: deterministic simulated failures, for tests and
    the train launcher's --fail-at.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    fail_at_steps: tuple = ()
    fail_once: bool = True

    def __post_init__(self):
        self._fired = set()

    def check(self, step: int) -> None:
        """Raise SimulatedFailure at a step of `fail_at_steps` (once per
        step with `fail_once`)."""
        if step in self.fail_at_steps and step not in self._fired:
            if self.fail_once:
                self._fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


class StragglerDetector:
    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 warmup: int = 3):
        self.threshold = threshold
        self.alpha = alpha
        self.warmup = warmup
        self.ewma: Optional[float] = None
        self.n = 0
        self.flagged: list = []

    def observe(self, step: int, dt: float) -> bool:
        """True where step `step`, of `dt` seconds, is a straggler. The
        first `warmup` observations (the build and warm-up steps) are
        left out."""
        self.n += 1
        if self.n <= self.warmup:
            return False
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = dt > self.threshold * self.ewma
        if is_straggler:
            self.flagged.append((step, dt, self.ewma))
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


def elastic_mesh_shape(n_devices: int, model_parallel: int) -> tuple:
    """Largest (data, model) grid for the surviving devices, the model
    axis kept whole (a tensor-parallel group cannot shrink without
    resharding the layers)."""
    if n_devices < model_parallel:
        raise AssertionError(f"{n_devices} devices cannot hold a model "
                             f"axis of {model_parallel}")
    return (n_devices // model_parallel, model_parallel)


class Supervisor:
    """A step function with checkpoint-restart semantics."""

    def __init__(self, checkpointer, *, max_restarts: int = 3,
                 checkpoint_every: int = 50):
        self.ckpt = checkpointer
        self.max_restarts = max_restarts
        self.checkpoint_every = checkpoint_every
        self.restarts = 0
        self.straggler = StragglerDetector()

    def run_resilient(self, state, step_fn: Callable, n_steps: int, *,
                      start_step: int = 0,
                      injector: Optional[FailureInjector] = None,
                      on_metrics: Optional[Callable] = None, spec=None):
        """Run `step_fn(state, step) -> (state, metrics)` from
        `start_step` up to `n_steps`, `on_metrics(step, metrics, dt)`
        after each, and save the state without blocking every
        `checkpoint_every` steps (as step `step + 1`, the steps it has
        taken). On an exception: wait for the writer first (an
        in-flight save must land before the latest step is looked up),
        then restore the latest checkpoint into `state` and go on from
        its step, or retry the step on the live state where there is
        none; past `max_restarts` restarts the exception propagates,
        after the writer has finished. Returns (state, the step
        reached)."""
        step = start_step
        while step < n_steps:
            try:
                if injector is not None:
                    injector.check(step)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, step)
                dt = time.perf_counter() - t0
                self.straggler.observe(step, dt)
                if on_metrics is not None:
                    on_metrics(step, metrics, dt)
                step += 1
                if step % self.checkpoint_every == 0:
                    self.ckpt.save(step, state, spec=spec, blocking=False)
            except Exception:   # noqa: BLE001 (the supervisor's boundary)
                self.restarts += 1
                self.ckpt.wait()
                if self.restarts > self.max_restarts:
                    raise
                latest = self.ckpt.latest_step()
                if latest is None:
                    continue
                state = self.ckpt.restore(latest, state)
                step = latest
        self.ckpt.wait()
        return state, step
