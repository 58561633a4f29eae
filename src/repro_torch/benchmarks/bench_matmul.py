"""Table 2 / Fig 7: the GEMM on the card, beside the paper's seconds.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_matmul [--device cpu] [--n N]

Measured (`common.measure`): the n x n product in float32, float64 and
complex64 through each route: the naive kernel, the port's GEMM
chokepoint (the tiled kernel; complex64 by gauss3, three tiled launches;
float64 the plain f64 product) and `torch.matmul`. Modeled at the
paper's 4096 (`common.model_rows`): the paper's Tesla C1060 and C2050
beside Table 2's seconds, and the H100; then the H100 at the port's
kernel tile in bf16 and for complex via gauss3. The twin of the JAX
package's `benchmarks/bench_matmul.py`; its autotune sweep and
tuned-cache report wait for the port's autotuner.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import (device_label, emit, measure,
                                           model_rows, parse_args)
from repro_torch.configs.paper_gemm import CONFIG as PAPER
from repro_torch.core import blocking, hw, precision


def run(n: int, device) -> None:
    label = "cuda" if device.type == "cuda" else "cpu_plain"
    for r in measure(n, device):
        flops = precision.gemm_flops(n, n, n, r["dtype"])
        route = r["route"].replace(" ", "_").replace(".", "_")
        emit(f"matmul_{label}_{route}_{r['dtype']}_{n}", r["seconds"],
             f"gflops={flops / r['seconds'] / 1e9:.1f};"
             f"paper_c2050_s={r['paper_s']};device={device_label(device)}")

    m = PAPER.n
    for r in model_rows(m):
        t, ref = r["seconds"], r["paper_s"]
        emit(f"matmul_model_{r['chip']}_{r['route']}_f32_{m}", t,
             f"bound={r['bound']};block={r['block']}"
             + ("" if ref is None else
                f";paper_measured_s={ref};model/paper={t / ref:.3f}"))
    # the H100 at the tiled kernel's tile: bf16, and complex64 via gauss3
    # (3 real f32 GEMMs, not 4); f64 has no tiled kernel to model
    t_bf16, t_f32 = (blocking.gemm_time_model(
        m, m, m, size, blocking.KERNEL_TILE, chip=hw.H100)["t_total"]
        for size in (2, 4))
    emit(f"matmul_model_h100-sxm_tiled_bf16_{m}", t_bf16,
         f"gflops={2.0 * m ** 3 / t_bf16 / 1e9:.0f};block=64x64x32")
    emit(f"matmul_model_h100-sxm_tiled_complex64_gauss3_{m}", 3 * t_f32,
         "vs_naive4=1.33x")


def main(argv=None) -> None:
    args, device = parse_args(__doc__, argv)
    run(args.n, device)


if __name__ == "__main__":
    main()
