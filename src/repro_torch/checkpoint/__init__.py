"""Atomic, async checkpoints of a train state (the JAX package's
`repro/checkpoint`, its on-disk layout included)."""

from repro_torch.checkpoint.checkpointer import (Checkpointer, flatten,
                                                 unflatten)

__all__ = ["Checkpointer", "flatten", "unflatten"]
