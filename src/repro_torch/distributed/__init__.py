"""Distribution: the JAX package's `repro/distributed/` on
`torch.distributed`. The sharding rules (`sharding`: the reference's
table, `spec_for`, `param_specs`, `cache_specs`, `shardings_for`, and
the port's tensor-parallel layout `model_layout`), the current mesh and
the logical activation constraints (`context`), int8 error-feedback
gradient compression (`compression`), and fault tolerance of a training
run (`fault_tolerance`)."""

from repro_torch.distributed.compression import (
    EFState, compress_grads, compression_ratio, dequantize, init_ef, quantize)
from repro_torch.distributed.context import (
    constrain, current_mesh, mesh_context)
from repro_torch.distributed.fault_tolerance import (
    FailureInjector, SimulatedFailure, StragglerDetector, Supervisor,
    elastic_mesh_shape)
from repro_torch.distributed.sharding import (
    P, Sharding, cache_specs, data_spec, model_layout, param_specs, spec_for,
    shardings_for)

__all__ = ["EFState", "FailureInjector", "P", "Sharding", "SimulatedFailure",
           "StragglerDetector", "Supervisor", "cache_specs",
           "compress_grads", "compression_ratio", "constrain",
           "current_mesh", "data_spec", "dequantize", "elastic_mesh_shape",
           "init_ef", "mesh_context", "model_layout", "param_specs",
           "quantize", "shardings_for", "spec_for"]
