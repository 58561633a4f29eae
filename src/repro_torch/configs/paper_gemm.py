"""The paper's own workload: the 4096 x 4096 GEMM (and add/sub) in float,
double and complex-float, Table 2 and Figs 7-9. The port's copy of the
JAX package's `configs/paper_gemm.py`, value for value.

Not a model config; read by `launch/paper.py` and `benchmarks/`.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperWorkload:
    n: int = 4096
    dtypes: tuple = ("float32", "float64", "complex64")
    block: int = 16          # the paper's CUDA block edge
    # Table 2 wall-clock seconds (for the modeled comparison)
    reference_times = {
        ("xeon-e7-4860", "float32"): 991.96,
        ("xeon-e7-4860", "float64"): 1455.27,
        ("xeon-e7-4860", "complex64"): 1679.15,
        ("tesla-c2050", "float32"): 2.49,
        ("tesla-c2050", "float64"): 3.13,
        ("tesla-c2050", "complex64"): 4.17,
        ("tesla-c2050-shared", "float32"): 0.83,
        ("tesla-c2050-shared", "float64"): 1.60,
        ("tesla-c2050-shared", "complex64"): 2.07,
        ("tesla-c1060", "float32"): 5.81,
        ("tesla-c1060", "float64"): 8.56,
        ("tesla-c1060", "complex64"): 18.07,
    }


CONFIG = PaperWorkload()
