"""Time the port's SSD intra-chunk kernel (`csrc/ssd.cu`) against another
checkout's build of it (`--parent`) and against variants of itself, on
one card. A variant is the source with a few textual replacements
(among them other orders of a unit's jobs). Every build is held
against the plain version (`ref.ssd_intra_chunk_ref`, f32 tolerance
1e-4) and the committed kernel against the plain version on f64 copies
of its inputs (its max error beside the plain f32 version's); then all
are timed in turns (`chip_smoke.py`'s timer: CUDA events, L2 flushed,
card time only), `--rounds` times, to show the spread between rounds of
one call.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/parent
    PYTHONPATH=src python experiments/probe_ssd_kernels.py \
        --parent build/parent/src/repro_torch/kernels/csrc [--rounds 5]

Needs one CUDA card and nvcc; builds into build/probe_ssd/.
"""

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
from chip_smoke import Smoke, card_line          # noqa: E402
from repro_torch.kernels import _build, ref      # noqa: E402

OUT = ROOT / "build" / "probe_ssd"

# (name, {file: [(old, new)]}): variants of the committed source
_CVT = ("asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(x));\n"
        "  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));")
_MASK = ("hi = __float_as_uint(x) & 0xffffe000u;\n"
         "  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));")
_VELTKAMP = ("const float c = __fmul_rn(x, 8193.f);\n"
             "  const float h = __fsub_rn(c, __fsub_rn(c, x));\n"
             "  hi = __float_as_uint(h);\n  lo = __float_as_uint(__fsub_rn(x, h));")
_JOB = ("const int job = (int)blockIdx.y < nrow ? (int)blockIdx.y : "
        "~((int)blockIdx.y - nrow);")
_GRID = "row_tiles(args.Q) + (args.N + RT - 1) / RT"
_NST = "const int nst = (int)gridDim.y - nrow, yy = blockIdx.y;\n  "
_KT32_2 = [("constexpr int KT = 16;", "constexpr int KT = 32;"),
           ("__launch_bounds__(THREADS, 3)", "__launch_bounds__(THREADS, 2)")]
VARIANTS = [
    # one head a block: C B^T computed for each head, not once a pair
    ("one head", {"ssd.cu": [("const bool pairs = args.H / args.G % 2 == 0;",
                              "const bool pairs = false;")]}),
    # 32 keys a stage at two blocks an SM; 64 (one block an SM)
    ("KT=32", {"ssd.cu": _KT32_2}),
    ("KT=64", {"ssd.cu": [("constexpr int KT = 16;", "constexpr int KT = 64;"),
                          ("__launch_bounds__(THREADS, 3)", "__launch_bounds__(THREADS, 1)")]}),
    # the hi + lo split rounded (Veltkamp, four instructions) or by
    # cvt.rna.tf32.f32 and one subtraction, not truncated by a mask
    ("split Veltkamp", {"mma.cuh": [(_MASK, _VELTKAMP)]}),
    ("split cvt", {"mma.cuh": [(_MASK, _CVT)]}),
    ("split Veltkamp KT=32", {"mma.cuh": [(_MASK, _VELTKAMP)], "ssd.cu": _KT32_2}),
    # timed only: one tf32 pass a product (no split, no lo products);
    # no tile loads (the kernel's compute alone); no mma (the splits go
    # with them: loads, exp and barriers alone)
    ("1xTF32", {"mma.cuh": [(_MASK, "hi = __float_as_uint(x);\n  lo = 0u;")],
                "ssd.cu": [("if constexpr (!A_EXACT) {", "if constexpr (false) {"),
                           ("if constexpr (!B_EXACT) {", "if constexpr (false) {")]}),
    ("no loads", {"ssd.cu": [("const int cpr = cols / E;", "const int cpr = 0 * cols / E;")]}),
    ("no mma", {"mma.cuh": [('asm volatile(\n      "mma.sync.aligned.m16n8k8',
                             'if (false) asm volatile(\n      "mma.sync.aligned.m16n8k8')]}),
    # a unit's jobs in other orders: the opposite one (the states first,
    # then the row tiles longest first), and the row tiles longest first
    # before the states
    ("reversed", {"ssd.cu": [(_JOB, _NST + "const int job = yy < nst ? "
                              "~(nst - 1 - yy) : nrow - 1 - (yy - nst);")]}),
    ("longest first", {"ssd.cu": [(_JOB, _NST + "const int job = yy < nrow ? "
                                   "nrow - 1 - yy : ~(yy - nrow);")]}),
    # each kind of job alone (timed only): where the time goes
    ("rows only", {"ssd.cu": [(_GRID, "row_tiles(args.Q)")]}),
    ("states only", {"ssd.cu": [(_JOB, "const int job = ~(int)blockIdx.y;"),
                                (_GRID, "(args.N + RT - 1) / RT")]}),
]
LOOSE = {"1xTF32", "no loads", "no mma", "rows only", "states only"}  # timed only

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build(jobs):
    """jobs: {name: (csrc dir, {file: replacements})} -> {name: lib}."""
    procs = {}
    for name, (src, repl) in jobs.items():
        d = OUT / name.replace(" ", "_").replace("=", "")
        d.mkdir(parents=True, exist_ok=True)
        for f in ("ssd.cu", "common.cuh", "mma.cuh"):
            if not (src / f).exists():
                continue
            text = (src / f).read_text()
            for old, new in repl.get(f, []):
                assert old in text, (name, f, old)
                text = text.replace(old, new)
            (d / f).write_text(text)
        log = open(d / "nvcc.log", "w")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
               str(d / "lib.so"), str(d / "ssd.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), d, log)
    libs = {}
    for name, (p, d, log) in procs.items():
        rc = p.wait()
        log.close()
        text = (d / "nvcc.log").read_text()
        if rc != 0:
            raise SystemExit(f"{name}: nvcc failed\n{text[-4000:]}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        libs[name] = d / "lib.so"
    return libs


def launcher(path, parent):
    """A callable (x, a, b, c, q) -> (y, states) over the library; the
    parent's entry point takes no alignment flag."""
    lib = ctypes.CDLL(str(path))
    fn = lib.repro_ssd_intra_chunk
    fn.argtypes = [_P] * 6 + [_I] * 7 + [_L] * 12 \
        + ([] if parent else [_I]) + [_I, _P]
    fn.restype = ctypes.c_int

    def run(x, a, b, c, q):
        bsz, l, h, p = x.shape
        g, n = b.shape[-2:]
        y = torch.empty((bsz, l, h, p), dtype=torch.float32, device=x.device)
        st = torch.empty((bsz, h, l // q, n, p), dtype=torch.float32,
                         device=x.device)
        extra = [] if parent else [1]
        err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 y.data_ptr(), st.data_ptr(), bsz, l, h, g, p, n, q,
                 *x.stride()[:3], *a.stride(), *b.stride()[:3],
                 *c.stride()[:3], *extra, int(x.dtype == torch.bfloat16),
                 _build.stream_ptr(x.device))
        _build.check(err, "probe ssd")
        return y, st
    return run


def inputs(shape, dtype, seed=0):
    b, l, h, g, p, n, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, l, h, p), generator=gen, device="cuda")
    a = -(0.01 + 0.49 * torch.rand((b, l, h), generator=gen, device="cuda"))
    bm, cm = (torch.randn((b, l, g, n), generator=gen, device="cuda")
              * n ** -0.25 for _ in range(2))
    return x.to(dtype), a, bm.to(dtype), cm.to(dtype)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True,
                    help="csrc/ of the checkout to compare with")
    ap.add_argument("--also", action="append", default=[],
                    help="NAME=DIR: another csrc/ with this checkout's "
                         "entry point, timed beside it")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--warm", action="store_true",
                    help="time without flushing the L2 between launches")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_ssd_kernels: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_line()}", flush=True)
    csrc = _build.CSRC
    also = dict(a.split("=", 1) for a in args.also)
    libs = build({"parent": (args.parent, {}), "committed": (csrc, {}),
                  **{name: (Path(d), {}) for name, d in also.items()},
                  **{name: (csrc, repl) for name, repl in VARIANTS}})
    runs = {name: launcher(path, name == "parent")
            for name, path in libs.items()}
    smoke = Smoke(torch)
    if args.warm:
        from repro_torch.tuning import timing
        timing.FLUSH_BYTES = 16

    # (B, L, H, G, P, N, chunk): mamba2-2.7b's 512-token prefill, and its
    # ragged 200-token chunk
    for shape in [(1, 512, 80, 1, 64, 128, 256), (1, 200, 80, 1, 64, 128, 200)]:
        q = shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            x, a, bm, cm = inputs(shape, dtype)
            want = ref.ssd_intra_chunk_ref(x, a, bm, cm, q)
            fns = {name: (lambda r=r: r(x, a, bm, cm, q))
                   for name, r in runs.items()}
            label = f"{str(dtype)[6:]} {shape}"
            for name, fn in fns.items():
                got = fn()
                errs = [(u - v).abs().max().item() for u, v in zip(got, want)]
                ok = all(torch.allclose(u, v, atol=1e-4, rtol=1e-4)
                         for u, v in zip(got, want))
                print(f"  {label} {name:12s} max |err| y {errs[0]:.2e} "
                      f"states {errs[1]:.2e} {'ok' if ok else 'OFF'}")
                assert ok or name in LOOSE, (label, name, errs)
            if dtype == torch.float32:
                exact = ref.ssd_intra_chunk_ref(x.double(), a.double(),
                                                bm.double(), cm.double(), q)
                for name in ["committed", "parent", "plain"] + [
                        n for n in ("split Veltkamp", "split cvt") if n in fns]:
                    got = want if name == "plain" else fns[name]()
                    errs = [(u.double() - e).abs().max().item()
                            for u, e in zip(got, exact)]
                    print(f"  {label} {name:12s} against f64: y "
                          f"{errs[0]:.3e} states {errs[1]:.3e}")
            names = list(fns)
            order = ["parent"] + [n for n in names if n != "parent"] + ["parent*"]
            timed = [fns[n.rstrip("*")] for n in order]
            rounds = []
            for _ in range(args.rounds):
                rounds.append(smoke._time_turns(timed, n=50))
            for i, name in enumerate(order):
                ms = [r[i] for r in rounds]
                print(f"  {label} {name:12s} ms median of 50, {args.rounds} "
                      f"rounds: {' '.join(f'{m:.4f}' for m in ms)} (median "
                      f"{statistics.median(ms):.4f}, spread "
                      f"{max(ms) - min(ms):.4f})", flush=True)
            del x, a, bm, cm, want
    print(f"card: {card_line()}")


if __name__ == "__main__":
    main()
