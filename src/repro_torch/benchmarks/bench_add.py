"""Fig 9: matrix add and sub gain nothing from the accelerator.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_add [--device cpu] [--n N]

The paper finds add and sub bound by the transfers. Measured on the card
at n x n float32: `ops.add`, `ops.sub` and `ops.axpy` (alpha a number,
and a one-element tensor on the card), each in GB/s against the H100's
3.35 TB/s, and an add of operands that do not start on a 16-byte
boundary (the kernel's one-element path; aligned operands move 16 bytes
a load). Each result is checked, bit for bit, against its plain
version first. Then the arithmetic-intensity classifier's rows for the
C2050 and the H100: add memory-bound, the GEMM compute-bound. The twin
of the JAX package's `benchmarks/bench_add.py`.
"""

from __future__ import annotations

import torch

from repro_torch.benchmarks.common import device_label, emit, parse_args, time_s
from repro_torch.core import hw, intensity
from repro_torch.kernels import ops, ref

ALPHA = 0.5
#: Kernel launches of one call, by case.
LAUNCHES_PER_CALL = {"add": {"binary_op": 1}, "sub": {"binary_op": 1},
                     "axpy": {"axpy": 1}, "axpy_alpha_tensor": {"axpy": 1},
                     "add_unaligned": {"binary_op": 1}}


def _cases(n: int, device):
    """{case: (the op's call, its plain version's)}."""
    g = torch.Generator(device=device).manual_seed(0)
    x, y = (torch.randn((n, n), generator=g, device=device) for _ in range(2))
    # one element into a buffer: contiguous, 4 bytes off a 16-byte boundary
    xu, yu = (torch.randn(n * n + 1, generator=g, device=device)[1:].view(n, n)
              for _ in range(2))
    alpha_t = torch.full((1,), ALPHA, device=device)
    return {
        "add": (lambda: ops.add(x, y), lambda: ref.add_ref(x, y)),
        "sub": (lambda: ops.sub(x, y), lambda: ref.sub_ref(x, y)),
        "axpy": (lambda: ops.axpy(ALPHA, x, y),
                 lambda: ref.saxpy_ref(ALPHA, x, y)),
        "axpy_alpha_tensor": (lambda: ops.axpy(alpha_t, x, y),
                              lambda: ref.saxpy_ref(alpha_t, x, y)),
        "add_unaligned": (lambda: ops.add(xu, yu), lambda: ref.add_ref(xu, yu)),
    }


def measure(n: int, device, iters: int = 5, warmup: int = 1) -> list:
    """One row a case: the median seconds of a call over `iters` after
    `warmup` (and one checked call before them), its GB/s (two n x n
    float32 operands read, one written), and the kernel launches of all
    its calls (`calls` of them)."""
    rows = []
    nbytes = 3 * n * n * 4
    for name, (fn, plain) in _cases(n, device).items():
        before = ops.launch_counts()
        if not torch.equal(fn(), plain()):
            raise RuntimeError(f"{name}: the kernel's result is not its "
                               f"plain version's, bit for bit")
        seconds = time_s(fn, device, iters, warmup)
        after = ops.launch_counts()
        rows.append({"case": name, "seconds": seconds,
                     "gbps": nbytes / seconds / 1e9, "calls": 1 + warmup + iters,
                     "launches": {k: after[k] - before[k] for k in after
                                  if after[k] != before[k]}})
    return rows


def run(n: int, device) -> None:
    label = "cuda" if device.type == "cuda" else "cpu_plain"
    for r in measure(n, device):
        emit(f"{r['case']}_{label}_{n}", r["seconds"],
             f"GBps={r['gbps']:.1f};of_h100_hbm={r['gbps'] / (hw.H100.hbm_bw / 1e9):.3f};"
             f"device={device_label(device)}")
    # the classifier: claim C3 on the paper's card and on the H100
    for chip_name, chip in (("c2050", hw.TESLA_C2050), ("h100", hw.H100)):
        cl_add = intensity.classify(intensity.add_profile(n, n, 4),
                                    chip=chip, itemsize=4)
        cl_mm = intensity.classify(intensity.matmul_profile(n, n, n, 4),
                                   chip=chip, itemsize=4)
        emit(f"add_model_{chip_name}_{n}", cl_add["t_memory"],
             f"bound={cl_add['bound']};AI={cl_add['arithmetic_intensity']:.3f};"
             f"attainable_gflops={cl_add['attainable_flops'] / 1e9:.1f}")
        emit(f"matmul_model_{chip_name}_{n}_for_contrast",
             max(cl_mm["t_compute"], cl_mm["t_memory"]),
             f"bound={cl_mm['bound']};AI={cl_mm['arithmetic_intensity']:.0f}")


def main(argv=None) -> None:
    args, device = parse_args(__doc__, argv)
    run(args.n, device)


if __name__ == "__main__":
    main()
