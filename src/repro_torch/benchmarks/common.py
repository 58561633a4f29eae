"""What the paper's entry point (`launch/paper.py`) and the benchmark twins
share: CSV lines in the JAX package's format (`name,us_per_call,derived`),
a timer, the command line, and the paper's measurement and model (Table
2 and Fig 8), which `launch.paper` prints and the twins emit.

The timer reads the card's clock: CUDA events around each call, with
the 50 MB L2 flushed before it (a 64 MB buffer zeroed), as `chip_smoke.py`
times its kernels. On the CPU it reads the host's clock, and what it
gives is a CPU time of the plain versions, never a device time.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.configs.paper_gemm import CONFIG as PAPER
from repro_torch.core import blocking, gemm, hw, precision
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ops

FLUSH_BYTES = 64 << 20                  # more than the H100's 50 MB L2


def emit(name: str, seconds: float, derived: str = "") -> str:
    line = f"{name},{seconds * 1e6:.1f},{derived}"
    print(line)
    return line


def device_label(device: torch.device) -> str:
    """What ran: the card's name, or the CPU (the plain versions)."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu (plain versions; not a device time)"


def time_s(fn, device: torch.device, iters: int = 3, warmup: int = 1) -> float:
    """Median seconds of one `fn()` over `iters` calls after `warmup`."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in events) / 1e3


def parse_args(doc: str, argv=None):
    """--device (cuda, the default, or cpu) and --n (the paper's 4096 on
    the card, 256 on the CPU); returns (args, device). Raises where the
    card is asked for and there is none. Every f32 product on the card
    runs in full f32 (TF32 off)."""
    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=None,
                    help="matrix size (default 4096 on the card, 256 on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    args.n = args.n or (4096 if device.type == "cuda" else 256)
    torch.backends.cuda.matmul.allow_tf32 = False
    return args, device


# ------------------------------------------------- Table 2, measured

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "complex64": torch.complex64}
#: Each dtype's routes: the naive kernel; the port's GEMM chokepoint
#: (`core.gemm.matmul`): the tiled kernel, or for float64, which the
#: tiled kernel refuses, the plain f64 product (a library DGEMM, the
#: route the JAX package gives f64); and the library's product.
ROUTES = {"float32": ("naive", "tiled", "torch.matmul"),
          "float64": ("naive", "f64 product", "torch.matmul"),
          "complex64": ("naive", "tiled", "torch.matmul")}
#: Kernel launches of one product, by (route, dtype).
LAUNCHES_PER_CALL = {
    ("naive", "float32"): {"matmul_naive": 1},
    ("naive", "float64"): {"matmul_naive": 1},
    ("naive", "complex64"): {"matmul_naive": 3},
    ("tiled", "float32"): {"matmul": 1},
    ("f64 product", "float64"): {},
    ("tiled", "complex64"): {"matmul": 3},
    **{("torch.matmul", d): {} for d in DTYPES},
}
#: The paper's column of Table 2 that each route reproduces. The port has
#: no shared-memory f64 kernel, so no route stands beside the paper's
#: double "shared" seconds.
PAPER_COLUMN = {"naive": "tesla-c2050", "tiled": "tesla-c2050-shared"}


def naive_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_complex():
        return precision.complex_matmul(a, b, ops.matmul_naive, "gauss3")
    return ops.matmul_naive(a, b)


_ROUTE_FNS = {"naive": naive_matmul, "tiled": gemm.matmul,
              "f64 product": gemm.matmul, "torch.matmul": torch.matmul}


def operands(n: int, dtype: torch.dtype, device, seed: int = 0):
    """A and B, n x n, made on `device` from `seed`: standard normals (the
    real and imaginary parts drawn apart), B scaled by n^-1/2 so that the
    product's entries are of order 1."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(scale):
        real = torch.float64 if dtype == torch.float64 else torch.float32
        x = torch.randn((n, n), generator=g, device=device, dtype=real)
        if dtype.is_complex:
            x = torch.complex(x, torch.randn((n, n), generator=g,
                                             device=device, dtype=real))
        return (x * scale).to(dtype)
    return draw(1.0), draw(n ** -0.5)


def tolerance(dtype: torch.dtype, k: int) -> float:
    """The largest |C - C_f64| accepted: k roundings of a partial sum of
    order 1 at the working precision (2^-24 for f32, 2^-53 for f64),
    four times that for gauss3's three products and their sums."""
    u = 2.0 ** -53 if dtype == torch.float64 else 2.0 ** -24
    return (4 if dtype.is_complex else 1) * k * u


def measure(n: int, device, iters: int = 3, warmup: int = 1) -> list:
    """One row a (dtype, route): the median seconds of a product over
    `iters` calls after `warmup` (and one checked call before them), its
    max error against the f64 product, and the kernel launches of all
    its calls (`calls` of them)."""
    rows = []
    for name, dtype in DTYPES.items():
        a, b = operands(n, dtype, device)
        wide = torch.complex128 if dtype.is_complex else torch.float64
        want = torch.matmul(a.to(wide), b.to(wide))
        tol = tolerance(dtype, n)
        for route in ROUTES[name]:
            fn = _ROUTE_FNS[route]
            before = ops.launch_counts()
            got = fn(a, b)
            if got.shape != want.shape or got.dtype != dtype:
                raise RuntimeError(f"{route} {name}: {got.dtype} "
                                   f"{tuple(got.shape)}")
            err = (got.to(wide) - want).abs().max().item()
            if not err <= tol:
                raise RuntimeError(f"{route} {name}: max |err| {err:g} > "
                                   f"{tol:g} against the f64 product")
            del got
            seconds = time_s(lambda: fn(a, b), device, iters, warmup)
            after = ops.launch_counts()
            rows.append({
                "dtype": name, "route": route, "seconds": seconds,
                "max_abs_err": err, "tol": tol, "iters": iters,
                "calls": 1 + warmup + iters,
                "launches": {k: after[k] - before[k] for k in after
                             if after[k] != before[k]},
                "paper_s": PAPER.reference_times.get(
                    (PAPER_COLUMN.get(route), name))})
        del a, b, want
    return rows


def paper_ratio(dtype: str) -> float:
    """Table 2's naive over shared-memory seconds on the C2050 (Fig 8)."""
    t = PAPER.reference_times
    return t[("tesla-c2050", dtype)] / t[("tesla-c2050-shared", dtype)]


def naive_over_tiled(rows: list) -> dict:
    """Fig 8's ratio for each dtype that has a tiled kernel (not f64)."""
    by = {(r["dtype"], r["route"]): r["seconds"] for r in rows}
    return {d: by[(d, "naive")] / by[(d, "tiled")] for d in DTYPES
            if (d, "tiled") in by}


# --------------------------------------------------- Table 2, modeled

def model_rows(n: int = PAPER.n) -> list:
    """The device-memory roofline model at float32, one dict a row: the
    paper's cards as `examples/paper_reproduction.py` models them (the
    chooser's tile), then the H100 naive and at the port's kernel tile.
    Keys: chip, route, seconds, bound, bytes, block (or None), paper_s
    (Table 2's seconds, or None)."""
    ref = PAPER.reference_times
    c1060 = blocking.choose_block_config(n, n, n, 4, chip=hw.TESLA_C1060)
    c2050 = blocking.choose_block_config(n, n, n, 4, chip=hw.TESLA_C2050)
    rows = []
    for chip, route, cfg, column in (
            (hw.TESLA_C1060, "shared", c1060, "tesla-c1060"),
            (hw.TESLA_C2050, "naive", None, "tesla-c2050"),
            (hw.TESLA_C2050, "shared", c2050, "tesla-c2050-shared"),
            (hw.H100, "naive", None, None),
            (hw.H100, "tiled", blocking.KERNEL_TILE, None)):
        m = blocking.gemm_time_model(n, n, n, 4, cfg, chip=chip)
        rows.append({
            "chip": chip.name, "route": route, "seconds": m["t_total"],
            "bound": m["bound"], "bytes": m["bytes"],
            "block": None if cfg is None else f"{cfg.bm}x{cfg.bn}x{cfg.bk}",
            "paper_s": ref.get((column, "float32"))})
    return rows
