"""Build the PyTorch port's CUDA kernels and drive the port on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure propagates and the exit code is not 0:
  1. card: its name and power limit; TF32 off for every f32 product;
  2. build: the kernels of src/repro_torch/kernels/csrc/, one nvcc each,
     all at once, with ptxas' register and shared-memory report;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     shapes of the main paths (qwen3-0.6b decode and prefill; dense, paged
     and int8; training attention, forward and backward; mamba2-2.7b's
     SSD intra-chunk work, ragged chunks, groups, bf16, a carried state,
     strong decays and zamba2's d_state; the paper's naive GEMM at 4096^2
     against the f64 product, and add, sub, mul and axpy bit for bit),
     with the max error beside its tolerance, and the median time of the
     kernel, the plain version and one PyTorch library call beside the
     least time the card could take; a bf16 page pool must give the dense
     decode kernel's bits;
  4. the dense slice at full width: qwen3-0.6b (28 layers, random weights
     from a seed) served by the engine on 4 slots to 8 requests, with
     every kernel's launches counted over that run; a torch.profiler trace
     of decode steps at 4 busy slots (the card's busy time a step, by
     kernel, against the step's wall time); then two requests whose
     engine streams must equal whole-prompt prefill plus batch-1 decode;
  5. the paged slices at full width: phase 4's trace on a bf16 page pool
     must give phase 4's streams bit for bit; a prefix-heavy chat trace on
     an int8 page pool with int8 weights (prefix pages shared), with
     exact launch counts, speed, memory and the pool's report; and that
     configuration's streams at 4 slots equal to each request alone;
  6. training at full width: 8 AdamW steps of qwen3-0.6b (f32 params,
     bf16 activations) at batch 4 x 512 tokens, with exact launch counts
     a step, finite losses and grad norms, a falling loss, speed, memory
     and a torch.profiler trace of a step; the first 4 steps again
     through the plain versions on the card, step 0 held to the kernels';
     then a whole step at depth 2 in f32 on the card against the same
     step on the CPU;
  7. Mamba-2 serving at full width: mamba2-2.7b (64 layers, random
     weights from a seed) served by the engine on 4 slots to 8 requests
     whose prompts take every prefill branch, with exact launch counts
     (the SSD kernel in every admission prefill), each stream equal to
     the request run alone at batch 1, speed, memory and a torch.profiler
     trace of decode steps and of a 512-token prefill; then a depth-2
     prefill and decode in f32 on the card against the same on the CPU;
  8. the paper's experiment at its size, 4096^2: Table 2 through the
     measurement `launch.paper` prints (`benchmarks.common.measure`: float,
     double and complex-float through the naive kernel, the GEMM
     chokepoint (the tiled kernel; f64 the plain f64 product) and
     torch.matmul, each checked against the f64 product, beside the
     paper's seconds; the naive/tiled ratio beside the paper's 3.0x), Fig 9 through `benchmarks.bench_add`'s
     (add, sub and axpy in GB/s beside 3.35 TB/s), with exact launch
     counts; then the roofline model of the paper's cards and the H100;
  9. a JSON line of the kernels, the card line, and the result line.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLUSH_BYTES = 64 << 20                                  # > the 50 MB L2


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on a "
              "card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    smoke = Smoke(torch)
    smoke.phase_card()
    smoke.phase_build()
    smoke.phase_kernels()
    smoke.phase_serve()
    smoke.phase_trace()
    smoke.phase_batching()
    smoke.phase_paged()
    smoke.phase_train()
    smoke.phase_train_vs_cpu()
    smoke.phase_mamba()
    smoke.phase_mamba_vs_cpu()
    smoke.phase_paper()
    print("[9/9] result")
    print(json.dumps({"kernels": smoke.kernel_rows()}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class Smoke:
    def __init__(self, torch):
        from repro_torch.core import hw
        self.torch = torch
        self.dev = torch.device("cuda")
        self.chip = hw.H100    # the card's peaks: device memory, FLOP/s by dtype
        self.results = {}      # kernel name -> list of case dicts
        self.launches = {}

    # -- 1. card ------------------------------------------------------
    def phase_card(self):
        torch = self.torch
        print(f"[1/9] card: {card_line()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"      torch {torch.__version__} cuda {torch.version.cuda}; "
              f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
              f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # -- 2. build -----------------------------------------------------
    def phase_build(self):
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        libs = _build.build_all()
        print(f"[2/9] build: {sorted(libs)} from "
              f"{_build.CSRC.relative_to(ROOT)} in "
              f"{time.perf_counter() - t0:.1f} s (nvcc "
              f"{' '.join(_build.NVCC_FLAGS)})")
        for name in sorted(libs):
            for line in _build.build_log(name).splitlines():
                if "registers" in line or "bytes stack frame" in line:
                    print(f"      {name}: {line.strip()}")

    # -- 3. kernels against their plain versions ------------------------
    def _time_ms(self, fn, n=50, warmup=3):
        """Median of n launches by CUDA events, L2 flushed before each
        (decode reads each weight once a step: the caller finds it cold)."""
        torch = self.torch
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=self.dev)
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        for start, end in ev:
            flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)

    def _case(self, kernel, label, run_kernel, run_plain, run_library,
              nbytes, flops, dtype, tol, reference=None, n_time=50):
        """Compare, then time. tol = (atol, rtol) on |kernel - plain|, or
        a list of them for a kernel of several outputs. run_library: a
        callable to time, or a time measured by the caller, or None.
        reference: a callable whose result (of a wider dtype) the kernel
        is held against in place of the plain version's."""
        torch = self.torch
        got = run_kernel()
        torch.cuda.synchronize()
        want = (reference or run_plain)()
        torch.cuda.synchronize()
        outs = list(zip(*((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))))
        tols = tol if isinstance(tol, list) else [tol] * len(outs)
        max_err = 0.0
        for (got, want), (atol, rtol) in zip(outs, tols):
            assert got.shape == want.shape and (
                reference or got.dtype == want.dtype), \
                (label, got.shape, want.shape, got.dtype, want.dtype)
            wide = torch.float64 if want.dtype == torch.float64 \
                else torch.float32
            g, w = got.to(wide), want.to(wide)
            assert torch.isfinite(g).all(), \
                f"{kernel} {label}: non-finite output"
            err = (g - w).abs()
            bad = err > atol + rtol * w.abs()
            max_err = max(max_err, err.max().item())
            assert not bad.any(), (f"{kernel} {label}: {int(bad.sum())} "
                                   f"elements off, max |err| "
                                   f"{err.max().item():g} (atol {atol:g} "
                                   f"rtol {rtol:g})")
        atol, rtol = tols[0]
        ms = self._time_ms(run_kernel, n=n_time)
        plain_ms = self._time_ms(run_plain, n=n_time)
        lib_ms = self._time_ms(run_library, n=n_time) \
            if callable(run_library) else run_library
        t_bytes = nbytes / self.chip.hbm_bw * 1e3
        t_ops = flops / self.chip.peak_flops(getattr(torch, dtype).itemsize) * 1e3
        row = dict(label=label, max_abs_err=max_err, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        self.results.setdefault(kernel, []).append(row)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"      {kernel:19s} {label:44s} err {max_err:.2e} "
              f"(atol {atol:g} rtol {rtol:g})  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f}  library {lib}  bound {row['bound_ms']:.4f} "
              f"({row['bound_by']})")

    def phase_kernels(self):
        torch = self.torch
        from repro_torch.kernels import ops, ref
        F = torch.nn.functional
        print("[3/9] kernels against their plain versions (median of 50, "
              "L2 flushed)")
        gen = torch.Generator(device=self.dev).manual_seed(0)

        def randn(*shape, dtype, scale=1.0):
            x = torch.randn(shape, generator=gen, device=self.dev) * scale
            return x.to(dtype)

        tols = {torch.bfloat16: (1e-3, 2 ** -7), torch.float32: (1e-4, 1e-4)}
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            size = torch.finfo(dtype).bits // 8
            tol = tols[dtype]
            # -- matmul: the projections, the residual down-projection,
            #    the tied-embedding logits, each bias epilogue once
            cases = [(m, k, n, "none") for m in (4, 256)
                     for k, n in ((1024, 2048), (1024, 1024), (2048, 1024))]
            cases += [(m, 3072, 1024, "residual") for m in (4, 256)]
            cases += [(256, 1024, 3072, ep)
                      for ep in ("bias", "bias_gelu", "bias_silu")]
            for m, k, n, ep in cases:
                a = randn(m, k, dtype=dtype)
                b = randn(k, n, dtype=dtype, scale=k ** -0.5)
                kw, e_bytes = {}, 0
                if ep == "residual":
                    kw["residual"] = randn(m, n, dtype=dtype)
                    e_bytes = m * n * size
                elif ep != "none":
                    kw["bias"] = randn(n, dtype=dtype)
                    e_bytes = n * size
                lib = {"none": lambda a=a, b=b: torch.matmul(a, b),
                       "residual": lambda a=a, b=b, r=kw.get("residual"):
                           torch.addmm(r, a, b),
                       "bias": lambda a=a, b=b, r=kw.get("bias"):
                           torch.addmm(r, a, b)}.get(ep)
                self._case(
                    "matmul", f"{dname} M={m} K={k} N={n} {ep}",
                    lambda a=a, b=b, kw=kw: ops.matmul(a, b, epilogue=ep, **kw),
                    lambda a=a, b=b, kw=kw, ep=ep: ref.fused_matmul_ref(
                        a, b, dtype, ep, kw.get("bias"), kw.get("residual")),
                    lib, (m * k + k * n + m * n) * size + e_bytes,
                    2 * m * n * k, dname, tol)
            # the logits: x @ W_emb^T, W as an [N, K] operand, f32 out
            m, k, n = 4, 1024, 152064
            x = randn(m, k, dtype=dtype)
            w = randn(n, k, dtype=dtype, scale=k ** -0.5)
            self._case(
                "matmul", f"{dname} M={m} K={k} N={n} [N,K] B, f32 out",
                lambda: ops.matmul(x, w.t(), out_dtype=torch.float32),
                lambda: ref.fused_matmul_ref(x, w.t(), torch.float32),
                lambda: torch.matmul(x, w.t()),
                (m * k + k * n) * size + m * n * 4, 2 * m * n * k, dname,
                tols[torch.float32])
            del w
            # -- gated_matmul: the SwiGLU gate/up at decode and prefill
            for m in (4, 256):
                k, n = 1024, 3072
                a = randn(m, k, dtype=dtype)
                wg = randn(k, n, dtype=dtype, scale=k ** -0.5)
                wu = randn(k, n, dtype=dtype, scale=k ** -0.5)
                self._case(
                    "gated_matmul", f"{dname} M={m} K={k} N={n}",
                    lambda a=a, wg=wg, wu=wu: ops.gated_matmul(a, wg, wu),
                    lambda a=a, wg=wg, wu=wu: ref.gated_matmul_ref(a, wg, wu),
                    None, (m * k + 2 * k * n + m * n) * size, 4 * m * n * k,
                    dname, tol)
            # -- flash_decode: 4 slots, one idle, against a 2048-deep cache
            b_, h, hkv, d, tk = 4, 16, 8, 128, 2048
            pos_list = [-1, 0, 700, 2047]
            q = randn(b_, 1, h, d, dtype=dtype)
            kc = randn(b_, tk, hkv, d, dtype=dtype)
            vc = randn(b_, tk, hkv, d, dtype=dtype)
            pos = torch.tensor(pos_list, dtype=torch.int32, device=self.dev)
            for window in (None, 512):
                keys = [0 if p < 0 else min(p + 1, window or p + 1)
                        for p in pos_list]
                lo = [max(0, p - window + 1) if window else 0 for p in pos_list]
                mask = torch.zeros((b_, 1, 1, tk), dtype=torch.bool,
                                   device=self.dev)
                for i, p in enumerate(pos_list):
                    mask[i, ..., lo[i]:p + 1] = True
                self._case(
                    "flash_decode",
                    f"{dname} B={b_} H={h} Hkv={hkv} D={d} Tk={tk} "
                    f"window={window}",
                    lambda w_=window: ops.flash_decode(q, kc, vc, pos=pos,
                                                       window=w_),
                    lambda w_=window: ref.attention_fwd_ref(
                        q, kc, vc, window=w_, q_offset=pos),
                    lambda m_=mask: _sdpa(torch, F, q, kc, vc, m_),
                    (2 * q.numel() + 2 * sum(keys) * hkv * d) * size,
                    4 * sum(keys) * h * d, dname, tol)
            del q, kc, vc
        self._kernels_int8_and_paged(randn, tols[torch.bfloat16])
        self._kernels_attention(randn, tols)
        self._kernels_ssd(gen, tols)
        self._kernels_paper(randn, tols)

    def _kernels_int8_and_paged(self, randn, tol):
        """matmul_q at the int8 main path's shapes and flash_decode_paged
        on bf16 and int8 pools, bf16 activations."""
        torch = self.torch
        from repro_torch.core import precision
        from repro_torch.kernels import ops, ref
        dtype = torch.bfloat16
        # -- matmul_q: every dense layer of the int8-weight model; the
        #    down-projection carries the residual
        cases = [(m, k, n, "none") for m in (4, 256)
                 for k, n in ((1024, 2048), (1024, 1024), (2048, 1024),
                              (1024, 3072))]
        cases += [(m, 3072, 1024, "residual") for m in (4, 256)]
        for m, k, n, ep in cases:
            a = randn(m, k, dtype=dtype)
            wq, scale = precision.quantize_int8(
                randn(k, n, dtype=torch.float32, scale=k ** -0.5))
            r = randn(m, n, dtype=dtype) if ep == "residual" else None
            self._case(
                "matmul_q", f"bfloat16 M={m} K={k} N={n} int8 W {ep}",
                lambda a=a, wq=wq, s=scale, r=r, ep=ep: ops.matmul_q(
                    a, wq, s, epilogue=ep, residual=r),
                lambda a=a, wq=wq, s=scale, r=r, ep=ep: ref.matmul_q_ref(
                    a, wq, s, dtype, ep, residual=r),
                None, m * k * 2 + k * n + n * 4 + m * n * 2
                + (0 if r is None else m * n * 2),
                2 * m * n * k, "bfloat16", tol)
        # -- flash_decode_paged: 4 slots, 128 pages of 16 a slot, one idle,
        #    the pages shuffled over the pool, -1 past each prefix
        b_, h, hkv, d, ps, pp = 4, 16, 8, 128, 16, 128
        tk = pp * ps
        pos_list = [-1, 0, 700, 2047]
        q = randn(b_, 1, h, d, dtype=dtype)
        kc = randn(b_, tk, hkv, d, dtype=dtype)
        vc = randn(b_, tk, hkv, d, dtype=dtype)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=self.dev)
        perm = torch.randperm(b_ * pp, generator=torch.Generator()
                              .manual_seed(0)).to(self.dev)
        kp = torch.empty((b_ * pp, ps, hkv, d), dtype=dtype, device=self.dev)
        vp = torch.empty_like(kp)
        kp[perm] = kc.reshape(b_ * pp, ps, hkv, d)
        vp[perm] = vc.reshape(b_ * pp, ps, hkv, d)
        table = perm.reshape(b_, pp).to(torch.int32)
        for i, p in enumerate(pos_list):
            table[i, max(p, -1) // ps + 1:] = -1
        k8, ks = precision.quantize_kv(kp)
        v8, vs = precision.quantize_kv(vp)
        ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
        for window in (None, 512):
            # a bf16 pool gives the dense kernel's bits over the same values
            dense = ops.flash_decode(q, kc, vc, pos=pos, window=window)
            paged = ops.flash_decode_paged(q, kp, vp, table, pos=pos,
                                           window=window)
            assert torch.equal(paged, dense), \
                f"paged bf16 pool != dense cache bits, window={window}"
            lo = [max(0, p - window + 1) if window else 0 for p in pos_list]
            keys = sum(max(0, p - l + 1) for p, l in zip(pos_list, lo))
            pages = sum(p // ps - l // ps + 1 for p, l in zip(pos_list, lo)
                        if p >= 0)
            io = 2 * q.numel() * 2 + pages * 4 + b_ * 4     # q, o, table, pos
            for pool, (k_, v_, kw, elem) in {
                    "bf16": (kp, vp, {}, 2),
                    "int8": (k8, v8, dict(ks=ks, vs=vs), 1)}.items():
                nbytes = io + 2 * keys * hkv * (d * elem + (4 if kw else 0))
                self._case(
                    "flash_decode_paged",
                    f"bfloat16 {pool} pool B={b_} H={h} Hkv={hkv} D={d} "
                    f"ps={ps} pp={pp} window={window}",
                    lambda k_=k_, v_=v_, kw=kw, w_=window:
                        ops.flash_decode_paged(q, k_, v_, table, pos=pos,
                                               window=w_, **kw),
                    lambda k_=k_, v_=v_, kw=kw, w_=window:
                        ref.flash_decode_paged_ref(q, k_, v_, table, pos=pos,
                                                   window=w_, **kw),
                    None, nbytes, 4 * keys * h * d, "bfloat16", tol)
        print("      flash_decode_paged on a bf16 pool equals flash_decode on "
              "the dense cache, bit for bit (window None and 512)")

    def _kernels_attention(self, randn, tols):
        """flash_attention and flash_attention_bwd at the training shape
        (B=4, T=512, 16 query / 8 KV heads of 128, causal), with a window
        of 128 and at a ragged T=500, in bf16 and f32. The bound counts
        the unmasked (query, key) pairs only; the library yardsticks are
        SDPA's forward, and its forward + backward less its forward."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        F = torch.nn.functional
        b_, h, hkv, d = 4, 16, 8, 128
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            size = torch.finfo(dtype).bits // 8
            for t, window in ((512, None), (512, 128), (500, None)):
                q = randn(b_, t, h, d, dtype=dtype)
                k = randn(b_, t, hkv, d, dtype=dtype)
                v = randn(b_, t, hkv, d, dtype=dtype)
                do = randn(b_, t, h, d, dtype=dtype)
                pos = torch.arange(t, device=self.dev)
                mask = pos[None, :] <= pos[:, None]
                if window:
                    mask &= pos[None, :] > pos[:, None] - window
                pairs = int(mask.sum())
                label = (f"{dname} B={b_} T={t} H={h} Hkv={hkv} D={d} "
                         f"causal window={window}")
                qkv_bytes = (2 * q.numel() + 2 * k.numel()) * size
                lse_bytes = b_ * h * t * 4
                sdpa = _sdpa_train(torch, F, q, k, v, None if window is None
                                   else mask)
                self._case(
                    "flash_attention", label,
                    lambda: ops.flash_attention_fwd(q, k, v, window=window),
                    lambda: ref.flash_attention_fwd_ref(q, k, v,
                                                        window=window),
                    sdpa, qkv_bytes + lse_bytes, 4 * b_ * h * pairs * d,
                    dname, [tols[dtype], tols[torch.float32]])
                o, lse = ref.flash_attention_fwd_ref(q, k, v, window=window)
                fwd_ms = self._time_ms(sdpa)
                both_ms = self._time_ms(_sdpa_train(
                    torch, F, q, k, v, None if window is None else mask, do))
                self._case(
                    "flash_attention_bwd", label,
                    lambda: ops.flash_attention_bwd(q, k, v, o, do, lse,
                                                    window=window),
                    lambda: ref.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                                        window=window),
                    both_ms - fwd_ms, 2 * qkv_bytes + lse_bytes,
                    10 * b_ * h * pairs * d, dname, tols[dtype])
                del q, k, v, do, o, lse

    def _kernels_ssd(self, gen, tols):
        """ssd_intra_chunk against its plain version (y_diag and the chunk
        states, both f32, so f32 tolerance also for bf16 inputs), and the
        whole scan (ops.ssd: the kernel, then the inter-chunk recurrence)
        against the plain chunked scan, y in the input dtype. x ~ N(0, 1),
        B and C scaled so that C . B ~ N(0, 1), -a ~ U(0.01, 0.5). The
        bound counts each input and output once, and the unmasked
        products: the causal half of C B^T and of S x, and the state. No
        single PyTorch call computes SSD, so there is no library time."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        from repro_torch.kernels import ssd as kssd

        def inputs(b, l, h, g, p, n, dtype, decay=None):
            x = torch.randn((b, l, h, p), generator=gen, device=self.dev)
            a = -(0.01 + 0.49 * torch.rand((b, l, h), generator=gen,
                                           device=self.dev)) \
                if decay is None else torch.full((b, l, h), -decay,
                                                 device=self.dev)
            bm, cm = (torch.randn((b, l, g, n), generator=gen, device=self.dev)
                      * n ** -0.25 for _ in range(2))
            return x.to(dtype), a, bm.to(dtype), cm.to(dtype)

        # (B, L, H, G, P, N, chunk, dtype, decay, init_state)
        f32, bf16 = torch.float32, torch.bfloat16
        cases = [(1, 512, 80, 1, 64, 128, 256, f32, None, False),
                 (1, 512, 80, 1, 64, 128, 256, bf16, None, False),
                 (1, 512, 80, 1, 64, 128, 256, f32, None, True),
                 (1, 512, 80, 1, 64, 128, 256, f32, 20.0, False),
                 (1, 200, 80, 1, 64, 128, 200, f32, None, False),
                 (1, 8, 80, 1, 64, 128, 8, f32, None, False),
                 (1, 2, 80, 1, 64, 128, 2, f32, None, False),
                 (2, 512, 8, 2, 64, 128, 256, f32, None, False),
                 (1, 512, 64, 1, 64, 64, 128, f32, None, False)]
        for b, l, h, g, p, n, q, dtype, decay, with_state in cases:
            dname = str(dtype).split(".")[-1]
            size = torch.finfo(dtype).bits // 8
            x, a, bm, cm = inputs(b, l, h, g, p, n, dtype, decay)
            nc = l // q
            pairs = q * (q + 1) // 2
            flops = b * h * nc * (2 * pairs * n + 2 * pairs * p + 2 * q * n * p)
            # the scan adds the state -> output products and the recurrence
            scan_flops = 2 * b * h * (l + nc) * n * p
            in_bytes = (x.numel() + bm.numel() + cm.numel()) * size \
                + a.numel() * 4
            label = (f"{dname} B={b} L={l} H={h} G={g} P={p} N={n} "
                     f"chunk={q}" + (f" a=-{decay:g}" if decay else ""))
            if with_state:
                s0 = torch.randn((b, h, p, n), generator=gen, device=self.dev)
                self._case(
                    "ssd", label + " scan from init_state",
                    lambda: ops.ssd(x, a, bm, cm, q, init_state=s0),
                    lambda: ref.ssd_chunked_ref(x, a, bm, cm, q, s0),
                    None, in_bytes + s0.numel() * 8 + x.numel() * size,
                    flops + scan_flops, "float32",
                    [tols[dtype], tols[f32]])
                continue
            self._case(
                "ssd", label,
                lambda: kssd.ssd_intra_chunk(x, a, bm, cm, q),
                lambda: ref.ssd_intra_chunk_ref(x, a, bm, cm, q),
                None, in_bytes + x.numel() * 4 + b * h * nc * n * p * 4,
                flops, "float32", tols[f32])
            if dtype == bf16 or decay:
                self._case(
                    "ssd", label + " scan",
                    lambda: ops.ssd(x, a, bm, cm, q),
                    lambda: ref.ssd_chunked_ref(x, a, bm, cm, q),
                    None, in_bytes + b * h * p * n * 4 + x.numel() * size,
                    flops + scan_flops, "float32",
                    [tols[dtype], tols[f32]])
            del x, a, bm, cm

    def _kernels_paper(self, randn, tols, n=4096):
        """The paper's kernels at its size n = 4096: the naive GEMM at n^2
        (f32 held to the f64 product within atol K 2^-24, K roundings of a
        partial sum of order 1; bf16 to its plain version), f64 at
        (n/4)^2 (atol K 2^-53) and a ragged f32 product; add, sub and mul
        in f32, bf16 and f64 at n^2, add at a ragged size, on unaligned
        operands and on complex64 (through the f32 view), and axpy with
        alpha a number and a tensor on the card, all bit for bit."""
        torch = self.torch
        from repro_torch.kernels import elementwise as kew
        from repro_torch.kernels import ops, ref
        f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
        exact = (0.0, 0.0)

        def name_size(dtype):
            return str(dtype).split(".")[-1], torch.finfo(dtype).bits // 8

        q = n // 4
        for m, k, nn, dtype, n_time in ((n, n, n, f32, 10), (n, n, n, bf16, 10),
                                        (q, q, q, f64, 50),
                                        (1000, 300, 700, f32, 50)):
            dname, size = name_size(dtype)
            a = randn(m, k, dtype=dtype)
            b = randn(k, nn, dtype=dtype, scale=k ** -0.5)
            reference, tol = None, tols.get(dtype)
            if dtype != bf16:
                tol = (k * 2.0 ** (-53 if dtype == f64 else -24), 0.0)
                reference = lambda a=a, b=b: ref.matmul_ref(a.double(),
                                                            b.double())
            self._case(
                "matmul_naive", f"{dname} M={m} K={k} N={nn}",
                lambda a=a, b=b: ops.matmul_naive(a, b),
                lambda a=a, b=b: ref.matmul_ref(a, b),
                lambda a=a, b=b: torch.matmul(a, b),
                (m * k + k * nn + m * nn) * size, 2 * m * nn * k, dname, tol,
                reference=reference, n_time=n_time)
            del a, b

        library = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}
        for dtype in (f32, bf16, f64):
            dname, size = name_size(dtype)
            for rows, cols, names in ((n, n, ("add", "sub", "mul")),
                                      (1000, 1001, ("add",))):
                x, y = randn(rows, cols, dtype=dtype), randn(rows, cols, dtype=dtype)
                for op in names:
                    self._case(
                        "binary_op", f"{dname} {op} {rows}x{cols}",
                        lambda x=x, y=y, op=op: kew.binary_op(x, y, op),
                        lambda x=x, y=y, op=op: ref.binary_ref(x, y, op),
                        lambda x=x, y=y, op=op: library[op](x, y),
                        3 * x.numel() * size, x.numel(), dname, exact)
            x, y = randn(n, n, dtype=dtype), randn(n, n, dtype=dtype)
            alpha_t = torch.full((1,), 0.7, device=self.dev)
            for alpha, how in ((0.7, "a number"), (alpha_t, "an f32 tensor")):
                self._case(
                    "axpy", f"{dname} {n}x{n}, alpha {how}",
                    lambda alpha=alpha: kew.axpy(alpha, x, y),
                    lambda alpha=alpha: ref.saxpy_ref(alpha, x, y),
                    lambda: torch.add(y, x, alpha=0.7),
                    3 * x.numel() * size, 2 * x.numel(), dname, exact)
            del x, y
        # unaligned operands (one element into a buffer): the one-element path
        xu, yu = (randn(n * n + 1, dtype=f32)[1:].view(n, n) for _ in range(2))
        self._case("binary_op", f"float32 add {n}x{n} unaligned operands",
                   lambda: ops.add(xu, yu), lambda: ref.add_ref(xu, yu),
                   lambda: torch.add(xu, yu), 3 * xu.numel() * 4, xu.numel(),
                   "float32", exact)
        # complex64: add on the (re, im) pairs, through ops.add
        xc, yc = (torch.complex(randn(n // 2, n // 2, dtype=f32),
                                randn(n // 2, n // 2, dtype=f32))
                  for _ in range(2))
        self._case("binary_op", f"complex64 add {n // 2}x{n // 2} (f32 view)",
                   lambda: torch.view_as_real(ops.add(xc, yc)),
                   lambda: torch.view_as_real(ref.add_ref(xc, yc)),
                   lambda: torch.add(xc, yc), 3 * xc.numel() * 8,
                   2 * xc.numel(), "float32", exact)
        del xu, yu, xc, yc

    # -- 4. the slice at full width --------------------------------------
    def phase_serve(self):
        torch = self.torch
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.kernels import ops
        from repro_torch.models import model as M
        from repro_torch.serving import ServingEngine, synthetic_trace
        cfg = get_config("qwen3-0.6b")
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator().manual_seed(0), self.dev)
        work = synthetic_trace(cfg, 8, rng=np.random.default_rng(0),
                               len_range=(64, 512), gen=32)
        # whole 16-token pages, the paged engine's rounding: phase 5's
        # paged engine on this trace then runs the same prefill shapes
        max_len = -(-max(len(it.prompt) + it.gen for it in work) // 16) * 16
        engine = ServingEngine(cfg, params, max_slots=4, max_len=max_len,
                               device=self.dev)
        del params                      # the engine keeps its bf16 copy
        torch.cuda.synchronize()
        print(f"[4/9] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
              f"heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.resolved_head_dim} "
              f"d_ff {cfg.d_ff} vocab {cfg.vocab}->{cfg.padded_vocab}; "
              f"weights ready in {time.perf_counter() - t0:.1f} s; "
              f"8 requests, prompts {[len(it.prompt) for it in work]}, gen 32, "
              f"4 slots, max_len {engine.max_len}")
        torch.cuda.reset_peak_memory_stats()
        reqs = [engine.submit(it.prompt, it.gen) for it in work]
        ops.reset_launch_counts()
        report = engine.run()
        torch.cuda.synchronize()
        self.launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        assert report["n_finished"] == len(reqs), report
        for r in reqs:
            assert len(r.generated) == r.max_new_tokens, (r.rid, r.generated)
            assert all(0 <= t < cfg.vocab for t in r.generated), r.generated
        # every one-token step (decode, or a prefill-remainder step) runs
        # 141 GEMMs (28 x QKV/O/down + the logits), 28 dual GEMMs and 28
        # decode attentions; every prefill 141 GEMMs and 28 dual GEMMs
        steps = engine.decode_steps + sum(len(r.prompt) % 8 for r in reqs)
        n_pre = len(reqs)
        L = cfg.n_layers
        want = _no_launches(matmul=(5 * L + 1) * (steps + n_pre),
                            gated_matmul=L * (steps + n_pre),
                            flash_decode=L * steps)
        print(f"      launches {self.launches} (expected {want}: "
              f"{engine.decode_steps} decode steps at 141/28/28 each)")
        assert self.launches == want, (self.launches, want)
        print(f"      prefill {report['prefill_tok_s']:.1f} tok/s, decode "
              f"{report['decode_tok_s']:.1f} tok/s (occupancy "
              f"{report['mean_occupancy']:.2f}/4), decode step p50 "
              f"{report['decode_step_p50_s'] * 1e3:.2f} ms p99 "
              f"{report['decode_step_p99_s'] * 1e3:.2f} ms, latency p50 "
              f"{report['latency_p50_s'] * 1e3:.0f} ms p95 "
              f"{report['latency_p95_s'] * 1e3:.0f} ms, ttft p50 "
              f"{report['ttft_p50_s'] * 1e3:.0f} ms; max_memory_allocated "
              f"{peak / 2 ** 30:.3f} GiB")
        self.engine = engine
        self.work, self.max_len = work, engine.max_len
        self.dense_streams = [list(r.generated) for r in reqs]

    def phase_trace(self):
        self._trace(self.engine)

    def _trace(self, eng, n_steps=6):
        """Trace decode steps of `eng` with 4 slots busy at a depth of
        ~260: the card's busy time a step, by kernel, beside the step's
        wall time on the host clock (the profiler's own host cost
        included, so the idle share read here is an upper bound)."""
        torch = self.torch
        import numpy as np
        from torch.profiler import ProfilerActivity, profile
        rng = np.random.default_rng(2)
        for _ in range(4):
            eng.submit(rng.integers(0, eng.cfg.vocab, 256).astype(np.int32),
                       n_steps + 2)
        eng.step()                      # admits all four, one decode step
        assert eng.scheduler.n_active == 4, eng.scheduler.n_active
        first = len(eng._step_times)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                eng.step()
            torch.cuda.synchronize()
        eng.run()
        wall_ms = sum(eng._step_times[first:first + n_steps]) / n_steps * 1e3
        _print_trace(prof, f"{n_steps} decode steps at 4 slots", wall_ms,
                     n_steps)

    def phase_batching(self):
        """The engine (batch-1 prefill, then decode at 4 slots with a
        per-slot pos vector) emits what whole-prompt prefill plus batch-1
        lock-step decode emits, bit for bit: the kernels have no split-K
        and no atomic, and the norms reduce in an order that does not
        depend on the batch, so a row sums in the same order at any
        batch."""
        import numpy as np
        from repro_torch.serving import ServingEngine
        cfg, params = self.engine.cfg, self.engine.params
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
                   for n in (64, 136)]
        n_new = 16
        eng = ServingEngine(cfg, params, max_slots=4, max_len=160,
                            device=self.dev)
        reqs = [eng.submit(p, n_new) for p in prompts]
        eng.run()
        for req, prompt in zip(reqs, prompts):
            assert req.generated == self._alone(eng, prompt, n_new), req.rid
        print(f"      batching: engine streams of {len(prompts)} requests "
              f"(prompts {[len(p) for p in prompts]}, {n_new} tokens) equal "
              f"whole-prompt prefill + batch-1 decode, token for token")

    # -- 5. the paged slices at full width ---------------------------------
    def _run_counted(self, engine, work):
        """Serve `work`, with the launch counts set to 0 just before and
        read just after. Returns (requests, report, launches)."""
        torch = self.torch
        from repro_torch.kernels import ops
        reqs = [engine.submit(it.prompt, it.gen) for it in work]
        ops.reset_launch_counts()
        report = engine.run()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        assert report["n_finished"] == len(reqs), report
        for r in reqs:
            assert len(r.generated) == r.max_new_tokens, (r.rid, r.generated)
            assert all(0 <= t < engine.cfg.vocab for t in r.generated), \
                r.generated
        return reqs, report, launches

    @staticmethod
    def _want_launches(engine, reqs, per_gemm_step):
        """Launch counts of a run: every prefill and every one-token step
        runs the step's GEMMs; an admission's remainder steps (dense
        batch-1 sub-cache) decode with flash_decode, the decode steps on
        the pool with flash_decode_paged."""
        L = engine.cfg.n_layers
        rem = sum(len(r.prompt) % 8 for r in reqs)
        runs = engine.decode_steps + rem + len(reqs)
        want = _no_launches(flash_decode=L * rem,
                            flash_decode_paged=L * engine.decode_steps)
        for name, n in per_gemm_step.items():
            want[name] = n * runs
        return want

    def phase_paged(self):
        torch = self.torch
        import numpy as np
        from repro_torch.models import model as M
        from repro_torch.serving import ServingEngine, prefix_heavy_trace
        cfg = self.engine.cfg
        L = cfg.n_layers
        del self.engine                  # free phase 4's engine
        params = M.init_params(cfg, torch.Generator().manual_seed(0), self.dev)

        # 1. phase 4's trace on a bf16 page pool: phase 4's streams, bit for bit
        work = self.work
        eng = ServingEngine(cfg, params, max_slots=4, max_len=self.max_len,
                            device=self.dev, kv_layout="paged")
        assert eng.max_len == self.max_len, (eng.max_len, self.max_len)
        reqs, rep, launches = self._run_counted(eng, work)
        want = self._want_launches(eng, reqs, {"matmul": 5 * L + 1,
                                               "gated_matmul": L})
        assert launches == want, (launches, want)
        got = [r.generated for r in reqs]
        assert got == self.dense_streams, "paged bf16 streams != dense streams"
        print(f"[5/9] paged bf16 KV (page 16, {rep['kv_pool']['n_pages']} "
              f"pages): phase 4's {len(reqs)} streams, token for token; "
              f"launches {launches} ({eng.decode_steps} decode steps at "
              f"141/28/28 each); prefill {rep['prefill_tok_s']:.1f} tok/s, "
              f"decode {rep['decode_tok_s']:.1f} tok/s, decode step p50 "
              f"{rep['decode_step_p50_s'] * 1e3:.2f} ms p99 "
              f"{rep['decode_step_p99_s'] * 1e3:.2f} ms")
        del eng

        # 2. prefix-heavy chat on an int8 pool with int8 weights
        work = prefix_heavy_trace(cfg, 8, rng=np.random.default_rng(0),
                                  prefix_len=392, suffix_range=(16, 128),
                                  gen=32)
        max_len = max(len(it.prompt) + it.gen for it in work)
        eng = ServingEngine(cfg, params, max_slots=4, max_len=max_len,
                            device=self.dev, kv_layout="paged",
                            quant_kv="int8", quant="int8", page_size=16)
        del params
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        weights = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reqs, rep, launches = self._run_counted(eng, work)
        peak = torch.cuda.max_memory_allocated()
        want = self._want_launches(eng, reqs, {"matmul_q": 7 * L,
                                               "matmul": 1})
        assert launches == want, (launches, want)
        kv = rep["kv_pool"]
        assert kv["shared_page_hits"] > 0, kv
        self.paged_launches = launches
        print(f"      int8 KV + int8 weights: {len(reqs)} requests, prompts "
              f"{[len(it.prompt) for it in work]} (a 392-token shared "
              f"prefix), gen 32, 4 slots, max_len {eng.max_len}; launches "
              f"{launches} ({eng.decode_steps} decode steps at 196/1/28 "
              f"each)")
        print(f"      prefill {rep['prefill_tok_s']:.1f} tok/s, decode "
              f"{rep['decode_tok_s']:.1f} tok/s (occupancy "
              f"{rep['mean_occupancy']:.2f}/4), decode step p50 "
              f"{rep['decode_step_p50_s'] * 1e3:.2f} ms p99 "
              f"{rep['decode_step_p99_s'] * 1e3:.2f} ms, latency p50 "
              f"{rep['latency_p50_s'] * 1e3:.0f} ms, ttft p50 "
              f"{rep['ttft_p50_s'] * 1e3:.0f} ms; memory_allocated before "
              f"the run (weights + pool) {weights / 2 ** 30:.3f} GiB, "
              f"max_memory_allocated {peak / 2 ** 30:.3f} GiB")
        print(f"      kv pool: {json.dumps(kv)}")
        self._trace(eng)

        # 3. batch invariance there: 4 slots against each request alone
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
                   for n in (64, 136)]
        n_new = 16

        def streams(slots, batch):
            e = ServingEngine(cfg, eng.params, max_slots=slots, max_len=160,
                              device=self.dev, kv_layout="paged",
                              quant_kv="int8", quant="int8", page_size=16,
                              kv_pool_pages=40)
            rs = [e.submit(p, n_new) for p in batch]
            e.run()
            return [r.generated for r in rs]

        together = streams(4, prompts)
        alone = [streams(1, [p])[0] for p in prompts]
        assert together == alone, (together, alone)
        print(f"      batch invariance: int8 streams of {len(prompts)} "
              f"requests (prompts {[len(p) for p in prompts]}, {n_new} "
              f"tokens) at 4 slots equal each alone in a 1-slot engine")

    # -- 6. training at full width -----------------------------------
    def phase_train(self, steps=8, batch=4, seq=512):
        """8 AdamW steps of qwen3-0.6b at full width and depth: f32
        params, bf16 activations, random weights from seed 0, SyntheticLM
        batches from seed 0, lr 1e-3 with 2 warmup steps, clip 1.0. The
        loss must end below where it began. It does not within 4 steps:
        Adam's first steps, near sign(g) times lr for every weight, lift
        it (12.29 to 16.79 by step 3, through the kernels and through the
        plain versions alike, `_train_plain`), and it falls from step 4
        on."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.core.tree import leaves
        from repro_torch.data.pipeline import SyntheticLM
        from repro_torch.kernels import ops
        from repro_torch.optim.adamw import AdamW, cosine_schedule
        from repro_torch.training import train_loop as TL
        cfg = get_config("qwen3-0.6b")
        L = cfg.n_layers
        torch.cuda.empty_cache()
        opt = AdamW(lr=cosine_schedule(1e-3, 2, steps), clip_norm=1.0)
        state = TL.init_state(cfg, opt, torch.Generator().manual_seed(0),
                              self.dev)
        step_fn = TL.make_train_step(cfg, opt)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch, seed=0)
        batches = [{k: torch.as_tensor(v, dtype=torch.long, device=self.dev)
                    for k, v in data.batch_at(i).items()}
                   for i in range(steps + 1)]
        n_params = sum(x.numel() for x in leaves(state.params))
        # a step: the forward's 141 GEMMs, 28 dual GEMMs and 28 attentions;
        # the backward's 2 GEMMs for each of the 141 (dx, dw) plus 4 for
        # each dual GEMM (its gate/up recompute and their dw; dx of the two
        # branches is 2 more), and 28 attention backwards
        want = _no_launches(matmul=(5 * L + 1) * 3 + 6 * L, gated_matmul=L,
                            flash_attention=L, flash_attention_bwd=L)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        losses, norms, times, per_step = [], [], [], []
        before = ops.launch_counts()
        for i in range(steps):
            t0 = time.perf_counter()
            state, met = step_fn(state, batches[i])
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            now = ops.launch_counts()
            per_step.append({k: now[k] - before[k] for k in now})
            before = now
        self.train_launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"[6/9] training {cfg.name} at full width ({L} layers, "
              f"{n_params / 1e6:.1f}M f32 params, bf16 activations): "
              f"{steps} AdamW steps at batch {batch} x {seq}")
        for i in range(steps):
            print(f"      step {i}: loss {losses[i]:.4f} grad norm "
                  f"{norms[i]:.4f} wall {times[i] * 1e3:.1f} ms "
                  f"({batch * seq / times[i]:.0f} tok/s)")
            assert per_step[i] == want, (i, per_step[i], want)
        assert all(map(math.isfinite, losses + norms)), (losses, norms)
        assert losses[-1] < losses[0], losses
        steady = statistics.median(times[1:])
        print(f"      launches a step {want} (each step exactly); over the "
              f"run {self.train_launches}; steady step {steady * 1e3:.1f} ms, "
              f"{batch * seq / steady:.0f} tok/s; max_memory_allocated "
              f"{peak / 2 ** 30:.3f} GiB")
        self._trace_train_step(step_fn, state, batches[steps])
        del state
        self._train_plain(cfg, opt, batches, losses, norms)

    def _train_plain(self, cfg, opt, batches, losses, norms, steps=4,
                     rtol=1e-3):
        """The first steps again from the same weights, with the kernel
        dispatchers sent to the plain PyTorch versions on the card: step
        0's loss and grad norm (no update yet) agree with the kernels'
        within rtol 1e-3 (bf16 activations rounded at other places);
        later steps are printed beside the kernels' (Adam's sign-like
        first steps amplify those differences)."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.training import train_loop as TL
        on_card = ops._on_card
        ops._on_card = lambda t: False
        try:
            state = TL.init_state(cfg, opt, torch.Generator().manual_seed(0),
                                  self.dev)
            step_fn = TL.make_train_step(cfg, opt)
            plain = []
            for i in range(steps):
                state, met = step_fn(state, batches[i])
                plain.append((float(met["loss"]), float(met["grad_norm"])))
        finally:
            ops._on_card = on_card
        del state
        torch.cuda.empty_cache()
        for i, (loss, gn) in enumerate(plain):
            print(f"      plain versions, step {i}: loss {loss:.4f} grad norm "
                  f"{gn:.4f} (kernels {losses[i]:.4f} / {norms[i]:.4f})")
        assert abs(plain[0][0] - losses[0]) <= rtol * abs(losses[0]), plain
        assert abs(plain[0][1] - norms[0]) <= rtol * abs(norms[0]), plain

    def _trace_train_step(self, step_fn, state, batch):
        """One more step under torch.profiler: the card's busy time, by
        kernel group, against the step's wall time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_fn(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        _print_trace(prof, "a train step", wall_ms)

    def phase_train_vs_cpu(self, batch=2, seq=256, tol=1e-4):
        """A whole train step at full width, depth 2, f32 activations, on
        the card (the CUDA kernels) and on the CPU (their plain versions)
        from the same weights and batch: the loss and the global grad norm
        agree within rtol 1e-4 (f32 sums in another order)."""
        torch = self.torch
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.core.tree import tree_map
        from repro_torch.data.pipeline import SyntheticLM
        from repro_torch.models import model as M
        from repro_torch.optim.adamw import AdamW
        from repro_torch.training import train_loop as TL
        cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                                  dtype="float32")
        opt = AdamW(lr=1e-3, clip_norm=1.0)
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch, seed=0)
        out = []
        for dev in (self.dev, torch.device("cpu")):
            p = tree_map(lambda x: x.to(dev), params)
            state = TL.TrainState(p, opt.init(p))
            b = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                 for k, v in data.batch_at(0).items()}
            t0 = time.perf_counter()
            state, met = TL.make_train_step(cfg, opt)(state, b)
            out.append((float(met["loss"]), float(met["grad_norm"]),
                        time.perf_counter() - t0))
        (loss, gn, tc), (loss_c, gn_c, tp) = out
        assert abs(loss - loss_c) <= tol * abs(loss_c), (loss, loss_c)
        assert abs(gn - gn_c) <= tol * abs(gn_c), (gn, gn_c)
        print(f"      depth 2, f32, batch {batch} x {seq}, one step: card "
              f"loss {loss:.6f} grad norm {gn:.6f} ({tc * 1e3:.0f} ms); CPU "
              f"loss {loss_c:.6f} grad norm {gn_c:.6f} ({tp * 1e3:.0f} ms); "
              f"rel diff {abs(loss - loss_c) / loss_c:.2e} / "
              f"{abs(gn - gn_c) / gn_c:.2e} (rtol {tol:g})")

    # -- 7. Mamba-2 serving at full width -------------------------------
    def phase_mamba(self):
        """mamba2-2.7b served on 4 slots to 8 requests, 32 tokens each.
        The prompts take every prefill branch: 2 (shorter than the conv
        width - 1), 13 (a bucket remainder), 200 (one ragged chunk), 256
        (one whole chunk), 397 (two chunks, padding and a remainder), 512,
        and two more. An admission prefill of bucketed length lb runs 64 x
        (in_proj, in_proj_bc, out_proj, and the conv tail's two
        projections) + the logits = 321 GEMMs and 64 SSD scans; each
        remainder token and each decode step 64 x 3 + 1 = 193 GEMMs."""
        torch = self.torch
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.kernels import ops
        from repro_torch.models import model as M
        from repro_torch.serving import ServingEngine
        cfg = get_config("mamba2-2.7b")
        L = cfg.n_layers
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator().manual_seed(0), self.dev)
        lengths = [2, 13, 200, 256, 397, 512, 97, 333]
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
                   for n in lengths]
        gen = 32
        eng = ServingEngine(cfg, params, max_slots=4,
                            max_len=max(lengths) + gen, device=self.dev)
        del params                      # the engine keeps its bf16 copy
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        weights = torch.cuda.memory_allocated()
        sc = cfg.ssm
        print(f"[7/9] {cfg.name}: {L} layers d_model {cfg.d_model} d_inner "
              f"{sc.expand * cfg.d_model} ({sc.expand * cfg.d_model // sc.head_dim}"
              f" SSD heads of {sc.head_dim}) d_state {sc.d_state} groups "
              f"{sc.n_groups} conv {sc.conv_width} chunk {sc.chunk} vocab "
              f"{cfg.vocab}->{cfg.padded_vocab}; weights ready in "
              f"{time.perf_counter() - t0:.1f} s ({weights / 2 ** 30:.3f} GiB "
              f"on the card, bf16); {len(prompts)} requests, prompts "
              f"{lengths}, gen {gen}, 4 slots, max_len {eng.max_len}")
        torch.cuda.reset_peak_memory_stats()
        reqs = [eng.submit(pr, gen) for pr in prompts]
        ops.reset_launch_counts()
        report = eng.run()
        torch.cuda.synchronize()
        self.mamba_launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        assert report["n_finished"] == len(reqs), report
        for r in reqs:
            assert len(r.generated) == gen, (r.rid, r.generated)
            assert all(0 <= t < cfg.vocab for t in r.generated), r.generated
        rem = sum(n % 8 if n >= 8 else 0 for n in lengths)
        one_token = eng.decode_steps + rem
        want = {k: 0 for k in self.mamba_launches}
        want.update(matmul=(5 * L + 1) * len(reqs) + (3 * L + 1) * one_token,
                    ssd=L * len(reqs))
        print(f"      launches {self.mamba_launches} (expected {want}: "
              f"{len(reqs)} admission prefills at 321/64, {rem} remainder "
              f"tokens and {eng.decode_steps} decode steps at 193/0)")
        assert self.mamba_launches == want, (self.mamba_launches, want)
        print(f"      prefill {report['prefill_tok_s']:.1f} tok/s, decode "
              f"{report['decode_tok_s']:.1f} tok/s (occupancy "
              f"{report['mean_occupancy']:.2f}/4), decode step p50 "
              f"{report['decode_step_p50_s'] * 1e3:.2f} ms p99 "
              f"{report['decode_step_p99_s'] * 1e3:.2f} ms, latency p50 "
              f"{report['latency_p50_s'] * 1e3:.0f} ms p95 "
              f"{report['latency_p95_s'] * 1e3:.0f} ms, ttft p50 "
              f"{report['ttft_p50_s'] * 1e3:.0f} ms; max_memory_allocated "
              f"{peak / 2 ** 30:.3f} GiB")

        # each stream equals the request run alone at batch 1: the same
        # bucketed prefill and remainder steps, then batch-1 decode
        for req, prompt in zip(reqs, prompts):
            assert req.generated == self._alone(eng, prompt, gen), \
                (req.rid, len(prompt))
        print(f"      the {len(reqs)} engine streams (decode at 4 slots) equal "
              f"each request run alone at batch 1, token for token")
        self._trace(eng, n_steps=4)
        self._trace_prefill(eng, prompts[5])
        del eng
        torch.cuda.empty_cache()

    def _alone(self, eng, prompt, n_new):
        """Greedy tokens of `prompt` run alone as `eng` admits it: a
        prefill of its 8-bucket, the remainder one token at a time, then
        batch-1 decode steps."""
        torch = self.torch
        from repro_torch.models import model as M
        cfg, params = eng.cfg, eng.params
        toks = torch.as_tensor(prompt, dtype=torch.long, device=self.dev)
        n = len(prompt)
        lb = n - n % 8 or n
        cache = M.init_cache(cfg, 1, eng.max_len, self.dev)
        logits, cache = M.prefill(cfg, params, {"tokens": toks[None, :lb]},
                                  cache)
        for i in range(lb, n):
            logits, cache = M.decode_step(cfg, params, toks[None, i:i + 1], i,
                                          cache)
        out = []
        for i in range(n_new):
            row = logits[0, -1, :cfg.vocab]
            assert torch.isfinite(row).all(), "non-finite logits"
            out.append(int(torch.argmax(row)))
            if i + 1 < n_new:
                tok = torch.tensor([[out[-1]]], device=self.dev)
                logits, cache = M.decode_step(cfg, params, tok, n + i, cache)
        return out

    def _trace_prefill(self, eng, prompt):
        """One admission-shaped prefill of `prompt` (batch 1) under
        torch.profiler, after one untraced: the card's busy time by kernel
        group against the prefill's wall time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.models import model as M
        toks = torch.as_tensor(prompt, dtype=torch.long,
                               device=self.dev)[None]

        def run():
            cache = M.init_cache(eng.cfg, 1, eng.max_len, self.dev)
            return M.prefill(eng.cfg, eng.params, {"tokens": toks}, cache)[0]
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        _print_trace(prof, f"a {toks.shape[1]}-token prefill", wall_ms)

    def phase_mamba_vs_cpu(self, n_layers=2, length=300, steps=4, tol=1e-4):
        """mamba2-2.7b at full width, depth 2, f32 activations: a prefill
        of a 300-token prompt (one whole chunk and a padded ragged one)
        and 4 decode steps on the card (the CUDA kernels) and on the CPU
        (their plain versions) from the same weights: logits and every
        state leaf within rtol 1e-4, atol 1e-4 x the largest |value| (f32
        sums in another order)."""
        torch = self.torch
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.core.tree import tree_map
        from repro_torch.models import model as M
        cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=n_layers,
                                  dtype="float32")
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(0, cfg.vocab, (1, length + steps),
                             generator=torch.Generator().manual_seed(1))
        out = []
        for dev in (self.dev, torch.device("cpu")):
            p = tree_map(lambda x: x.to(dev), params)
            cache = M.init_cache(cfg, 1, length + steps, dev)
            t0 = time.perf_counter()
            logits, cache = M.prefill(cfg, p, {"tokens": toks[:, :length]
                                               .to(dev)}, cache)
            logs = [logits]
            for i in range(steps):
                logits, cache = M.decode_step(
                    cfg, p, toks[:, length + i:length + i + 1].to(dev),
                    length + i, cache)
                logs.append(logits)
            got = [t.cpu() for t in logs] + [v.cpu() for v in cache.values()]
            out.append((got, time.perf_counter() - t0))
        (card, tc), (cpu, tp) = out
        worst = 0.0
        for x, y in zip(card, cpu):
            assert torch.isfinite(x).all(), "non-finite output on the card"
            scale = y.abs().max().item()
            torch.testing.assert_close(x, y, rtol=tol, atol=tol * scale)
            worst = max(worst, ((x - y).abs().max() / scale).item())
        print(f"      depth {n_layers}, f32, a {length}-token prefill and "
              f"{steps} decode steps: card ({tc * 1e3:.0f} ms) against CPU "
              f"({tp * 1e3:.0f} ms): logits and states within rtol {tol:g}; "
              f"max |diff| / max |value| {worst:.2e}")

    # -- 8. the paper's experiment ---------------------------------------
    def phase_paper(self, n=4096, iters=3):
        """Table 2 and Figs 8-9 at the paper's size through the port's
        entry points: the measurement `launch.paper` prints (float, double
        and complex-float through the naive kernel, the GEMM chokepoint and
        torch.matmul, each checked against the f64 product) and
        `benchmarks.bench_add`'s (add, sub and axpy, each bit for bit with
        its plain version), with exact launch counts."""
        torch = self.torch
        from repro_torch.benchmarks import bench_add, common
        from repro_torch.kernels import ops
        from repro_torch.launch import paper
        print(f"[8/9] the paper's experiment at n={n} (Table 2, Figs 8-9)")
        ops.reset_launch_counts()
        gemm_rows = common.measure(n, self.dev, iters=iters)
        add_rows = bench_add.measure(n, self.dev)
        torch.cuda.synchronize()
        self.paper_launches = ops.launch_counts()
        want = _no_launches()
        for r, per_call in ([(r, common.LAUNCHES_PER_CALL[r["route"], r["dtype"]])
                             for r in gemm_rows]
                            + [(r, bench_add.LAUNCHES_PER_CALL[r["case"]])
                               for r in add_rows]):
            row_want = {k: v * r["calls"] for k, v in per_call.items()}
            assert r["launches"] == row_want, (r, row_want)
            for k, v in row_want.items():
                want[k] += v
        paper.print_measured(gemm_rows, n, self.dev)
        print(f"Fig 9, float32 {n}x{n} (median of 5, L2 flushed; each "
              f"result bit for bit its plain version's):")
        for r in add_rows:
            print(f"  {r['case']:18s} {r['seconds'] * 1e3:8.4f} ms "
                  f"{r['gbps']:8.1f} GB/s = {r['gbps'] * 1e9 / self.chip.hbm_bw:.3f} "
                  f"of 3.35 TB/s")
        print(f"      launches {self.paper_launches} (expected {want})")
        assert self.paper_launches == want, (self.paper_launches, want)
        paper.print_model()

    # -- 9. the kernels line --------------------------------------------
    def kernel_rows(self):
        """One row per kernel: its launches on the main path, the max error
        over every case, and the times of its main-path decode shape."""
        meta = {
            "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                       "src/repro/kernels/matmul.py:244",
                       "bfloat16 M=4 K=1024 N=152064 [N,K] B, f32 out"),
            "gated_matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                             "src/repro/kernels/matmul.py:360",
                             "bfloat16 M=4 K=1024 N=3072"),
            "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                             "src/repro/kernels/flash_attention.py:529",
                             "bfloat16 B=4 H=16 Hkv=8 D=128 Tk=2048 window=None"),
            "matmul_q": ("src/repro_torch/kernels/csrc/matmul.cu",
                         "src/repro/kernels/matmul.py:315",
                         "bfloat16 M=4 K=1024 N=3072 int8 W none"),
            "flash_decode_paged": (
                "src/repro_torch/kernels/csrc/flash_decode.cu",
                "src/repro/kernels/flash_attention.py:716",
                "bfloat16 int8 pool B=4 H=16 Hkv=8 D=128 ps=16 pp=128 "
                "window=None"),
            "flash_attention": (
                "src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:179",
                "bfloat16 B=4 T=512 H=16 Hkv=8 D=128 causal window=None"),
            "flash_attention_bwd": (
                "src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:373",
                "bfloat16 B=4 T=512 H=16 Hkv=8 D=128 causal window=None"),
            "ssd": ("src/repro_torch/kernels/csrc/ssd.cu",
                    "src/repro/kernels/ssd.py:185",
                    "float32 B=1 L=512 H=80 G=1 P=64 N=128 chunk=256"),
            "matmul_naive": ("src/repro_torch/kernels/csrc/matmul_naive.cu",
                             "src/repro/kernels/matmul_naive.py:56",
                             "float32 M=4096 K=4096 N=4096"),
            "binary_op": ("src/repro_torch/kernels/csrc/elementwise.cu",
                          "src/repro/kernels/elementwise.py:48",
                          "float32 add 4096x4096"),
            "axpy": ("src/repro_torch/kernels/csrc/elementwise.cu",
                     "src/repro/kernels/elementwise.py:75",
                     "float32 4096x4096, alpha a number"),
        }
        # launches: the dense kernels' from phase 4's run, the int8 path's
        # from phase 5's int8 run, the training kernels' from phase 6's,
        # the SSD kernel's from phase 7's, the paper's kernels from phase 8's
        counts = {**self.launches,
                  **{k: self.paper_launches[k]
                     for k in ("matmul_naive", "binary_op", "axpy")},
                  **{k: self.paged_launches[k]
                     for k in ("matmul_q", "flash_decode_paged")},
                  **{k: self.train_launches[k]
                     for k in ("flash_attention", "flash_attention_bwd")},
                  "ssd": self.mamba_launches["ssd"]}
        rows = []
        for name, (source, replaces, label) in meta.items():
            cases = self.results[name]
            rep = next(c for c in cases if c["label"] == label)
            rows.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": rep["ms"], "plain_ms": rep["plain_ms"],
                "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
                "library_ms": rep["library_ms"], "shape": label})
        return rows


def _no_launches(**counts) -> dict:
    """Every kernel's launch count 0, but for `counts`."""
    from repro_torch.kernels import ops
    return {**dict.fromkeys(ops.launch_counts(), 0), **counts}


def _print_trace(prof, what: str, wall_ms: float, n: int = 1) -> None:
    """The card's busy time in a torch.profiler trace of `n` repeats of
    `what`, by kernel group with its launches, against the wall time of
    one (the profiler's own host cost included, so the idle share read
    here is an upper bound)."""
    from torch.autograd import DeviceType
    busy, count = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        group = _kernel_group(e.name)
        busy[group] = busy.get(group, 0.0) + e.time_range.elapsed_us() / 1e3
        count[group] = count.get(group, 0) + 1
    if not busy:
        print("      trace: the profiler recorded no device time "
              "(not measured)")
        return
    each = " a step" if n > 1 else ""
    total = sum(busy.values()) / n
    parts = ", ".join(f"{g} {busy[g] / n:.3f} ms ({count[g] // n} launches)"
                      for g in sorted(busy, key=busy.get, reverse=True))
    print(f"      trace: {what} under torch.profiler: wall {wall_ms:.2f} ms"
          f"{each}; card busy {total:.3f} ms{each}: {parts}; idle share "
          f"{1 - total / wall_ms:.3f}")


def _kernel_group(name: str) -> str:
    """A profiler kernel name's group: one of the port's kernels (by the
    template arguments of its instantiation), memcpy, or other."""
    if "gated_matmul_kernel" in name:
        return "gated_matmul"
    if "matmul_kernel" in name:
        return "matmul_q" if "signed char" in name else "matmul"
    if "flash_decode_kernel" in name:
        return "flash_decode" if "false, false>" in name \
            else "flash_decode_paged"
    if "flash_attn_fwd_kernel" in name:
        return "flash_attention"
    if "flash_attn_bwd" in name:
        return "flash_attention_bwd"
    if "ssd_chunk_kernel" in name:
        return "ssd"
    return "memcpy" if name.startswith("Mem") else "other"


def _sdpa(torch, F, q, k, v, mask):
    """The library yardstick for decode attention (timed only; a fully
    masked row is NaN there, where the kernel gives zeros)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if torch.__version__ >= "2.5":
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    g = q.shape[2] // k.shape[2]
    return F.scaled_dot_product_attention(
        qt, kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1),
        attn_mask=mask)


def _sdpa_train(torch, F, q, k, v, mask, do=None):
    """The library yardstick for training attention (timed only): SDPA's
    causal forward (a bool mask with a window), and with `do` its forward
    and backward."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(do is not None)
                  for x in (q, k, v))
    g = q.shape[2] // k.shape[2]
    if torch.__version__ >= "2.5":
        kw = {"enable_gqa": True}
    else:
        kt, vt, kw = kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1), {}
    kw.update(is_causal=True) if mask is None else kw.update(attn_mask=mask)

    def run():
        o = F.scaled_dot_product_attention(qt, kt, vt, **kw)
        if do is not None:
            o.backward(do.transpose(1, 2))
        return o
    return run


if __name__ == "__main__":
    sys.exit(main())
