"""Table 2 of the paper on the card: the n x n GEMM in float, double and
complex-float through the naive kernel (the paper's Listing 3), the
tiled kernel (Listing 4) and `torch.matmul`, each time beside the
seconds the paper measured on a Tesla C2050; then the roofline model of
the paper's cards and of the H100.

    PYTHONPATH=src python -m repro_torch.launch.paper                 # the card, n = 4096
    PYTHONPATH=src python -m repro_torch.launch.paper --device cpu --n 128

Routes (`benchmarks.common.ROUTES`): "naive" is `ops.matmul_naive`
(complex: three naive products, by gauss3); "tiled" is `core.gemm.matmul`,
the port's GEMM chokepoint (the tiled kernel; complex: three tiled
products, by gauss3); for float64, which the tiled kernel refuses, the
chokepoint's route is "f64 product", the plain f64 product (a library
DGEMM), so the port reproduces no double naive/shared ratio;
"torch.matmul" is the library's product, the yardstick. Every result is
checked against the product in float64 (complex128) before it is timed.
Runs on the card unless `--device cpu` is given, and raises where there
is no card; on the CPU every route is a plain PyTorch version, and its
times are CPU times.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import (device_label, measure, model_rows,
                                           naive_over_tiled, paper_ratio,
                                           parse_args)
from repro_torch.configs.paper_gemm import CONFIG as PAPER
from repro_torch.core import precision


def print_measured(rows: list, n: int, device) -> None:
    print(f"== measured on {device_label(device)}, n={n}, median of "
          f"{rows[0]['iters']}{' (L2 flushed)' if device.type == 'cuda' else ''} ==")
    print(f"{'dtype':11s}{'route':14s}{'seconds':>12s}{'GFLOP/s':>10s}"
          f"{'max |err|':>11s}  {'paper C2050 s':>13s}  launches")
    for r in rows:
        flops = precision.gemm_flops(n, n, n, r["dtype"])
        paper = "" if r["paper_s"] is None else f"{r['paper_s']:.2f}"
        print(f"{r['dtype']:11s}{r['route']:14s}{r['seconds']:12.6f}"
              f"{flops / r['seconds'] / 1e9:10.1f}{r['max_abs_err']:11.2e}  "
              f"{paper:>13s}  {r['launches'] or '-'} in {r['calls']} calls")
    for d, x in naive_over_tiled(rows).items():
        print(f"naive / tiled, {d:9s}: {x:6.2f}x   (paper, C2050: "
              f"{paper_ratio(d):.2f}x)")
    print("float64: no tiled f64 kernel (the chokepoint's f64 route is a "
          "library DGEMM), so the paper's double naive/shared ratio is not "
          "reproduced")


def print_model(n: int = PAPER.n) -> None:
    print(f"\n== modeled, the paper's n={n}, float32 (device-memory "
          f"roofline) ==")
    print(f"{'config':38s}{'model s':>10s}{'paper s':>10s}  bound")
    for r in model_rows(n):
        name = f"{r['chip']} {r['route']}" + (
            f" ({r['block']} tile)" if r["block"] else "")
        paper = "-" if r["paper_s"] is None else f"{r['paper_s']:.2f}"
        print(f"{name:38s}{r['seconds']:10.4f}{paper:>10s}  {r['bound']}")


def main(argv=None):
    args, device = parse_args(__doc__, argv)
    rows = measure(args.n, device)
    print_measured(rows, args.n, device)
    print_model()
    return rows


if __name__ == "__main__":
    main()
