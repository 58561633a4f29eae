"""Build the PyTorch port's CUDA kernels and drive the port on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure propagates and the exit code is not 0:
  1. card: its name and power limit; TF32 off for every f32 product;
  2. build: the kernels of src/repro_torch/kernels/csrc/, one nvcc each,
     all at once, with ptxas' register and shared-memory report;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     shapes of the main paths (qwen3-0.6b decode and prefill; dense, paged
     and int8), with the max error beside its tolerance, and the median
     time of the kernel, the plain version and one PyTorch library call
     beside the least time the card could take; a bf16 page pool must
     give the dense decode kernel's bits;
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
  6. a JSON line of the kernels, the card line, and the result line.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12                                   # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}     # dense; f32 without TF32
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
    print("[6/6] result")
    print(json.dumps({"kernels": smoke.kernel_rows()}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.results = {}      # kernel name -> list of case dicts
        self.launches = {}

    # -- 1. card ------------------------------------------------------
    def phase_card(self):
        torch = self.torch
        print(f"[1/6] card: {card_line()}")
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
        print(f"[2/6] build: {sorted(libs)} from "
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
              nbytes, flops, dtype, tol):
        """Compare, then time. tol = (atol, rtol) on |kernel - plain|."""
        torch = self.torch
        got = run_kernel()
        torch.cuda.synchronize()
        want = run_plain()
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype, \
            (label, got.shape, want.shape, got.dtype, want.dtype)
        g, w = got.float(), want.float()
        assert torch.isfinite(g).all(), f"{kernel} {label}: non-finite output"
        err = (g - w).abs()
        atol, rtol = tol
        bad = err > atol + rtol * w.abs()
        max_err = err.max().item()
        assert not bad.any(), (f"{kernel} {label}: {int(bad.sum())} elements "
                               f"off, max |err| {max_err:g} (atol {atol:g} "
                               f"rtol {rtol:g})")
        ms = self._time_ms(run_kernel)
        plain_ms = self._time_ms(run_plain)
        lib_ms = None if run_library is None else self._time_ms(run_library)
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        row = dict(label=label, max_abs_err=max_err, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        self.results.setdefault(kernel, []).append(row)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"      {kernel:13s} {label:44s} err {max_err:.2e} "
              f"(atol {atol:g} rtol {rtol:g})  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f}  library {lib}  bound {row['bound_ms']:.4f} "
              f"({row['bound_by']})")

    def phase_kernels(self):
        torch = self.torch
        from repro_torch.kernels import ops, ref
        F = torch.nn.functional
        print("[3/6] kernels against their plain versions (median of 50, "
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
        print(f"[4/6] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
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
        want = {"matmul": (5 * L + 1) * (steps + n_pre), "matmul_q": 0,
                "gated_matmul": L * (steps + n_pre),
                "flash_decode": L * steps, "flash_decode_paged": 0}
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
        from torch.autograd import DeviceType
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
        total = sum(busy.values()) / n_steps
        parts = ", ".join(f"{g} {busy[g] / n_steps:.3f} ms "
                          f"({count[g] // n_steps} launches)"
                          for g in sorted(busy, key=busy.get, reverse=True))
        print(f"      trace: {n_steps} decode steps at 4 slots under "
              f"torch.profiler: wall {wall_ms:.2f} ms a step; card busy "
              f"{total:.3f} ms a step: {parts}; idle share "
              f"{1 - total / wall_ms:.3f}")

    def phase_batching(self):
        """The engine (batch-1 prefill, then decode at 4 slots with a
        per-slot pos vector) emits what whole-prompt prefill plus batch-1
        lock-step decode emits, bit for bit: the kernels have no split-K
        and no atomic, so a row sums in the same order at any batch."""
        torch = self.torch
        import numpy as np
        from repro_torch.models import model as M
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
            cache = M.init_cache(cfg, 1, eng.max_len, self.dev)
            toks = torch.as_tensor(prompt, dtype=torch.long, device=self.dev)
            logits, cache = M.prefill(cfg, params, {"tokens": toks[None]},
                                      cache)
            out = []
            for i in range(n_new):
                row = logits[0, -1, :cfg.vocab]
                assert torch.isfinite(row).all(), "non-finite logits"
                out.append(int(torch.argmax(row)))
                if i + 1 < n_new:
                    tok = torch.tensor([[out[-1]]], device=self.dev)
                    logits, cache = M.decode_step(cfg, params, tok,
                                                  len(prompt) + i, cache)
            assert req.generated == out, (req.rid, req.generated, out)
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
        want = {"matmul": 0, "matmul_q": 0, "gated_matmul": 0,
                "flash_decode": L * rem,
                "flash_decode_paged": L * engine.decode_steps}
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
        print(f"[5/6] paged bf16 KV (page 16, {rep['kv_pool']['n_pages']} "
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

    # -- 6. the kernels line --------------------------------------------
    def kernel_rows(self):
        """One row per kernel: its launches on the main path, the max error
        over every case, and the times of its main-path decode shape."""
        meta = {
            "matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                       "src/repro/kernels/matmul.py:189",
                       "bfloat16 M=4 K=1024 N=152064 [N,K] B, f32 out"),
            "gated_matmul": ("src/repro_torch/kernels/csrc/matmul.cu",
                             "src/repro/kernels/matmul.py:327",
                             "bfloat16 M=4 K=1024 N=3072"),
            "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                             "src/repro/kernels/flash_attention.py:478",
                             "bfloat16 B=4 H=16 Hkv=8 D=128 Tk=2048 window=None"),
            "matmul_q": ("src/repro_torch/kernels/csrc/matmul.cu",
                         "src/repro/kernels/matmul.py:256",
                         "bfloat16 M=4 K=1024 N=3072 int8 W none"),
            "flash_decode_paged": (
                "src/repro_torch/kernels/csrc/flash_decode.cu",
                "src/repro/kernels/flash_attention.py:631",
                "bfloat16 int8 pool B=4 H=16 Hkv=8 D=128 ps=16 pp=128 "
                "window=None"),
        }
        # launches: the dense kernels' from phase 4's run, the int8 path's
        # from phase 5's int8 run
        counts = {**self.launches,
                  **{k: self.paged_launches[k]
                     for k in ("matmul_q", "flash_decode_paged")}}
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


if __name__ == "__main__":
    sys.exit(main())
