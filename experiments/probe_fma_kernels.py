"""Try variants of the port's f32 GEMM (`csrc/matmul.cu`) and elementwise
kernels (`csrc/elementwise.cu`) on one card: each variant is the source
with a few textual replacements, built with the port's nvcc flags; every
variant is held bit for bit against a baseline build of another checkout's
sources (`--parent`), then timed in turns (`chip_smoke.py`'s timer: CUDA
events, L2 flushed, card time only) beside the library call.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/parent
    PYTHONPATH=src python experiments/probe_fma_kernels.py \
        --parent build/parent/src/repro_torch/kernels/csrc [--only gemm|ew]

Needs one CUDA card and nvcc; builds into build/probe/.
"""

import argparse
import ctypes
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
from chip_smoke import Smoke, card_line          # noqa: E402
from repro_torch.kernels import _build, ref      # noqa: E402
from repro_torch.kernels import matmul as tmm    # noqa: E402

OUT = ROOT / "build" / "probe"
EPILOGUES = ("none", "bias", "bias_gelu", "bias_silu", "residual")

# the wide f32 tile as committed, with its c-major operands staged by
# 4-byte cp.async (no registers) in place of 16-byte loads into
# registers, or with a warp of 2 x 16 threads in place of 4 x 8
_CP4 = [
    ("// ... and stored k-major once the stage before it has been used.",
     """__device__ __forceinline__ void stage_cmajor(float* S, const float* X, int extent, int K,
                                             long long ld, int c0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < WBK * WB / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int c = idx / WBK, k = idx % WBK;
    const int gc = c0 + c, gk = k0 + k;
    const bool in = gc < extent && gk < K;
    repro::cp_async4(S + k * WLD + c, in ? X + (long long)gc * ld + gk : X, in ? 4 : 0);
  }
}
// ... and stored k-major once the stage before it has been used."""),
    ("else fetch_cmajor(ra, A, M, K, lda, m0, k0, tid, vec_a);",
     "else stage_cmajor(As[t & 1], A, M, K, lda, m0, k0, tid);"),
    ("if constexpr (NK) fetch_cmajor(rb, B, N, K, ldb, n0, k0, tid, vec_b);",
     "if constexpr (NK) stage_cmajor(Bs[t & 1], B, N, K, ldb, n0, k0, tid);"),
    ("if constexpr (!KM) store_cmajor(As[t & 1], ra, tid);", ""),
    ("if constexpr (NK) store_cmajor(Bs[t & 1], rb, tid);", ""),
]
_W2X16 = [("const int tx = lane % 8 + 8 * (warp % 2), ty = lane / 8 + 4 * (warp / 2);",
           "const int tx = tid % 16, ty = tid / 16;")]
GEMM = {"wide": [], "cp4": _CP4, "2x16 warp": _W2X16}

# the elementwise kernels as committed (one 16-byte vector a thread, 256
# threads a block, streaming stores), and with other counts and stores
_PLAIN_STORE = [("__stcs(reinterpret_cast<uint4*>(c) + i, rc);",
                 "reinterpret_cast<uint4*>(c)[i] = rc;")]


def _shape(u, threads=256):
    return [("THREADS = 256, UNROLL = 1", f"THREADS = {threads}, UNROLL = {u}")]


EW = {"u1": [], "u2": _shape(2), "u4": _shape(4), "u1 t128": _shape(1, 128),
      "u1 t512": _shape(1, 512), "u1 plain stores": _PLAIN_STORE,
      "u4 plain stores": _shape(4) + _PLAIN_STORE,
      "u1 unaligned 1 a thread": [("return UNROLL * 16 / sizeof(T);",
                                   "return 1;")]}


def build(jobs):
    """jobs: {name: (source path, replacements)} -> {name: library path}."""
    procs = {}
    for name, (src, repl) in jobs.items():
        d = OUT / name.replace(" ", "_").replace("+", "_")
        d.mkdir(parents=True, exist_ok=True)
        for h in src.parent.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        text = src.read_text()
        for old, new in repl:
            assert old in text, (name, old)
            text = text.replace(old, new)
        (d / src.name).write_text(text)
        log = open(d / "nvcc.log", "w")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
               str(d / "lib.so"), str(d / src.name)]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), d, log)
    for name, (p, d, log) in procs.items():
        rc = p.wait()
        log.close()
        text = (d / "nvcc.log").read_text()
        if rc != 0:
            raise SystemExit(f"{name}: nvcc failed\n{text[-4000:]}")
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "wide" in entry and ("registers" in line or "spill" in line):
                print(f"  {name}: {entry[:40]}: {line.strip()}")
    return {name: d / "lib.so" for name, (_, d, _) in procs.items()}


_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double


def _gemm_lib(path, tiled):
    lib = ctypes.CDLL(str(path))
    lib.repro_matmul.argtypes = [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _I,
                                 _I, _I, _I, _I] + ([_I] if tiled else []) \
        + [_P]
    return lib


def _ew_lib(path):
    lib = ctypes.CDLL(str(path))
    lib.repro_binary_op.argtypes = [_P, _P, _P, _L, _I, _I, _I, _P]
    lib.repro_axpy.argtypes = [_P, _D, _P, _P, _P, _L, _I, _I, _P]
    return lib


def _layout(x):
    return (0, x.stride(0)) if x.stride(1) == 1 else (1, x.stride(1))


def gemm(lib, a, b, out=torch.float32, ep="none", e=None, tile=None):
    """C = epilogue(A @ B) through a build's repro_matmul; tile None for a
    build without the tile argument."""
    (m, k), n = a.shape, b.shape[1]
    (a_km, lda), (b_nk, ldb) = _layout(a), _layout(b)
    c = torch.empty((m, n), dtype=out, device=a.device)
    args = [a.data_ptr(), b.data_ptr(), None if e is None else e.data_ptr(),
            c.data_ptr(), m, n, k, lda, ldb, n if ep == "residual" else 0,
            a_km, b_nk, int(out == torch.bfloat16),
            int(e is not None and e.dtype == torch.bfloat16),
            EPILOGUES.index(ep)] + ([] if tile is None else [tile])
    assert lib.repro_matmul(*args, _build.stream_ptr(a.device)) == 0
    return c


def probe_gemm(smoke, rn, parent_csrc):
    libs = build({"gemm parent": (parent_csrc / "matmul.cu", []),
                  **{f"gemm {k}": (_build.CSRC / "matmul.cu", r)
                     for k, r in GEMM.items()}})
    parent = _gemm_lib(libs.pop("gemm parent"), tiled=False)
    variants = {k[5:]: _gemm_lib(v, tiled=True) for k, v in libs.items()}

    def operands(m, k, n, a_km, b_nk, off=0, pad=0):
        a = rn(k, m + off + pad)[:, off:off + m].t() if a_km \
            else rn(m, k + off + pad)[:, off:off + k]
        b = rn(n, k + off + pad)[:, off:off + k].t() if b_nk \
            else rn(k, n + off + pad)[:, off:off + n]
        return a, b

    same = differ = 0
    for m, k, n, off, pad in ((4096, 4096, 4096, 0, 0), (1000, 1000, 700, 0, 0),
                              (333, 77, 259, 1, 2), (257, 1001, 130, 0, 3),
                              (130, 0, 129, 0, 0), (129, 17, 131, 1, 0)):
        big = m * n * k > 1e10
        for a_km in (0, 1):
            for b_nk in (0, 1):
                a, b = operands(m, k, n, a_km, b_nk, off, pad)
                for ep in ("none",) if big else EPILOGUES:
                    e = None if ep == "none" else \
                        rn(m, n) if ep == "residual" else rn(n)
                    for out in (torch.float32,) if big else \
                            (torch.float32, torch.bfloat16):
                        want = gemm(parent, a, b, out, ep, e)
                        for name, lib in variants.items():
                            for tile in (0, 1):
                                got = gemm(lib, a, b, out, ep, e, tile)
                                iv = torch.int32 if out == torch.float32 \
                                    else torch.int16
                                if torch.equal(got.view(iv), want.view(iv)):
                                    same += 1
                                else:
                                    differ += 1
                                    print(f"  BITS DIFFER {name} tile {tile} "
                                          f"{(m, k, n, off, pad)} a_km {a_km} "
                                          f"b_nk {b_nk} {ep} {out}")
    print(f"gemm: {same} outputs the parent's bit for bit, {differ} not",
          flush=True)
    n = 4096
    for a_km, b_nk in ((0, 0), (0, 1), (1, 0), (1, 1)):
        a, b = operands(n, n, n, a_km, b_nk)
        fns = [lambda: gemm(parent, a, b)] + \
            [lambda lib=lib: gemm(lib, a, b, tile=1)
             for lib in variants.values()] + [lambda: torch.matmul(a, b)]
        ts = smoke._time_turns(fns, n=10)
        print(f"f32 {n}^2 a_km {a_km} b_nk {b_nk} (ms, TFLOP/s): "
              + " | ".join(f"{k} {t:.4f} {2 * n ** 3 / t / 1e9:.1f}"
                           for k, t in zip(["parent", *variants,
                                            "torch.matmul"], ts)),
              flush=True)
    # phase 3's f32 rows (chip_smoke.py), the committed tile plan against
    # the parent, in turns
    lib = variants["wide"]
    cases = [(m, k, n, "none") for m in (4, 256)
             for k, n in ((1024, 2048), (1024, 1024), (2048, 1024))]
    cases += [(m, 3072, 1024, "residual") for m in (4, 256)]
    cases += [(256, 1024, 3072, ep) for ep in ("bias", "bias_gelu",
                                                "bias_silu")]
    for m, k, n, ep in cases + [(4, 1024, 152064, "logits")]:
        a = rn(m, k)
        b = rn(n, k).t() if ep == "logits" else rn(k, n)
        e = rn(m, n) if ep == "residual" else \
            None if ep in ("none", "logits") else rn(n)
        ep_ = "none" if ep == "logits" else ep
        tile = tmm.f32_tile_plan(m, k, n)
        fns = [lambda: gemm(parent, a, b, ep=ep_, e=e),
               lambda: gemm(lib, a, b, ep=ep_, e=e, tile=tile.kernel)]
        ts = smoke._time_turns(fns + fns[::-1], n=50)
        print(f"phase 3 f32 M={m} K={k} N={n} {ep} ({tile.bm}x{tile.bn} "
              f"tile): parent {ts[0]:.4f} {ts[3]:.4f} ms, change "
              f"{ts[1]:.4f} {ts[2]:.4f}", flush=True)
    for m, k, n in ((256, 1024, 1024), (256, 1024, 3072), (512, 1024, 3072),
                    (1024, 1024, 3072), (2048, 1024, 1024),
                    (2048, 4096, 4096)):
        a, b = rn(m, k), rn(k, n)
        ts = smoke._time_turns([lambda: gemm(lib, a, b, tile=0),
                                lambda: gemm(lib, a, b, tile=1),
                                lambda: torch.matmul(a, b)], n=20)
        print(f"M={m} K={k} N={n} ({-(-m // 128) * -(-n // 128)} wide "
              f"blocks): 64x64 {ts[0]:.4f} ms, 128x128 {ts[1]:.4f}, "
              f"torch.matmul {ts[2]:.4f}", flush=True)


def probe_ew(smoke, rn, parent_csrc, dev):
    libs = build({"ew parent": (parent_csrc / "elementwise.cu", []),
                  **{f"ew {k}": (_build.CSRC / "elementwise.cu", r)
                     for k, r in EW.items()}})
    libs = {k[3:]: _ew_lib(v) for k, v in libs.items()}
    s = _build.stream_ptr(dev)
    x, y = rn(4096, 4096), rn(4096, 4096)
    for name, lib in libs.items():
        for dt, (xx, yy) in enumerate(((x, y), (x.bfloat16(), y.bfloat16()),
                                       (x.double(), y.double()))):
            for nel, off in ((xx.numel(), 0), (1000 * 1001, 0), (12345, 1),
                             (7, 0), (3, 0)):
                xs, ys = xx.flatten()[off:off + nel], yy.flatten()[off:off + nel]
                c = torch.empty_like(xs)
                vec = int(all(t.data_ptr() % 16 == 0 for t in (xs, ys, c)))
                for op in range(3):
                    assert lib.repro_binary_op(xs.data_ptr(), ys.data_ptr(),
                                               c.data_ptr(), nel, dt, op, vec,
                                               s) == 0
                    assert torch.equal(c, ref.binary_ref(
                        xs, ys, ("add", "sub", "mul")[op])), (name, dt, op)
                assert lib.repro_axpy(None, 0.7, xs.data_ptr(), ys.data_ptr(),
                                      c.data_ptr(), nel, dt, vec, s) == 0
                assert torch.equal(c, ref.saxpy_ref(0.7, xs, ys)), (name, dt)
    print("elementwise: every variant bit for bit its plain version",
          flush=True)

    def add(lib):
        c = torch.empty_like(x)
        lib.repro_binary_op(x.data_ptr(), y.data_ptr(), c.data_ptr(),
                            x.numel(), 0, 0, 1, s)

    def axpy(lib):
        c = torch.empty_like(x)
        lib.repro_axpy(None, 0.7, x.data_ptr(), y.data_ptr(), c.data_ptr(),
                       x.numel(), 0, 1, s)

    # operands one element into their buffers: the one-element path
    xu, yu = (rn(x.numel() + 1)[1:] for _ in range(2))

    def add_unaligned(lib):
        c = torch.empty_like(xu)
        lib.repro_binary_op(xu.data_ptr(), yu.data_ptr(), c.data_ptr(),
                            xu.numel(), 0, 0, 0, s)

    for rep in range(3):
        for what, fn, library in (("add", add, lambda: torch.add(x, y)),
                                  ("axpy", axpy,
                                   lambda: torch.add(y, x, alpha=0.7)),
                                  ("add unaligned", add_unaligned,
                                   lambda: torch.add(xu, yu))):
            ts = smoke._time_turns([library] + [lambda lib=lib: fn(lib)
                                                for lib in libs.values()],
                                   n=200)
            print(f"{what} f32 4096^2 run {rep} (ms): library {ts[0]:.4f} | "
                  + " | ".join(f"{k} {t:.4f}" for k, t in zip(libs, ts[1:])),
                  flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, required=True,
                    help="another checkout's kernels/csrc, the baseline")
    ap.add_argument("--only", choices=("gemm", "ew"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_fma_kernels: needs a CUDA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_line()}", flush=True)
    smoke = Smoke(torch)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    t0 = time.time()
    if args.only != "ew":
        probe_gemm(smoke, rn, args.parent)
    if args.only != "gemm":
        probe_ew(smoke, rn, args.parent, dev)
    print(f"done in {time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
