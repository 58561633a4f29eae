"""Fig 8: the shared-memory (tiled) GEMM against the naive one.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_shared_memory [--device cpu] [--n N]

The paper measures 2.49 s against 0.83 s (3.0x) on a Tesla C2050 at
4096^2 float. Reported: (a) the device-memory traffic model of both
kernels at the paper's 4096 (`common.model_rows`), for the C2050 (the
JAX chooser's tile, checkable against the paper's 3.0x) and the H100
(the port's kernel tile); (b) both kernels measured on the card at n
(`common.measure`), float32 and complex64: the tiled kernel (Listing 4)
against the naive kernel (Listing 3). The twin of the JAX package's
`benchmarks/bench_shared_memory.py`.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import (device_label, emit, measure,
                                           model_rows, naive_over_tiled,
                                           paper_ratio, parse_args)
from repro_torch.configs.paper_gemm import CONFIG as PAPER


def run(n: int, device) -> None:
    m = PAPER.n
    by = {(r["chip"], r["route"]): r for r in model_rows(m)}
    for chip, tiled_route in (("tesla-c2050", "shared"), ("h100-sxm", "tiled")):
        tiled, naive = by[(chip, tiled_route)], by[(chip, "naive")]
        emit(f"shared_memory_model_{chip}_tiled_{m}", tiled["seconds"],
             f"bound={tiled['bound']};traffic_GB={tiled['bytes'] / 1e9:.2f};"
             f"block={tiled['block']}")
        emit(f"shared_memory_model_{chip}_naive_{m}", naive["seconds"],
             f"bound={naive['bound']};traffic_GB={naive['bytes'] / 1e9:.2f};"
             f"speedup_tiled={naive['seconds'] / tiled['seconds']:.1f}x"
             + (";paper_measured=3.0x" if chip == "tesla-c2050" else ""))

    label = "cuda" if device.type == "cuda" else "cpu_plain"
    rows = measure(n, device)
    ratio = naive_over_tiled(rows)
    for r in rows:                      # f64 has no tiled kernel: left out
        if r["dtype"] not in ratio or r["route"] not in ("naive", "tiled"):
            continue
        derived = f"device={device_label(device)}"
        if r["route"] == "naive":
            derived = (f"speedup_tiled={ratio[r['dtype']]:.2f}x;"
                       f"paper_c2050={paper_ratio(r['dtype']):.2f}x;" + derived)
        emit(f"shared_memory_{label}_{r['route']}_{r['dtype']}_{n}",
             r["seconds"], derived)


def main(argv=None) -> None:
    args, device = parse_args(__doc__, argv)
    run(args.n, device)


if __name__ == "__main__":
    main()
