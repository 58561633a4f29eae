"""Fault tolerance of a single-process training run (the JAX package's
`repro/distributed/fault_tolerance.py`; its meshes, sharding rules and
collectives are not ported yet)."""

from repro_torch.distributed.fault_tolerance import (
    FailureInjector, SimulatedFailure, StragglerDetector, Supervisor,
    elastic_mesh_shape)

__all__ = ["FailureInjector", "SimulatedFailure", "StragglerDetector",
           "Supervisor", "elastic_mesh_shape"]
