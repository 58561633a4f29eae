"""Build the PyTorch port's CUDA kernels and drive the port on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure propagates and the exit code is not 0:
  1. card: its name and power limit, its L2 against `hw.H100.l2_bytes`;
     TF32 off for every f32 product;
  2. build: the kernels of src/repro_torch/kernels/csrc/, one nvcc each,
     all at once, with ptxas' register and shared-memory report;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     shapes of the main paths (qwen3-0.6b decode and prefill; dense, paged
     and int8; zamba2-1.2b's decode GEMMs, dual GEMM and decode attention
     (32 heads of 64, one a KV head); the int8 Mamba in_proj of zamba2
     and mamba2-2.7b; training attention, forward and backward; mamba2-2.7b's
     SSD intra-chunk work, ragged chunks, groups, bf16, a carried state,
     strong decays and zamba2's d_state; the dense configs' and
     qwen2-vl-2b's decode GEMMs (the QKV bias epilogue, bf16 and int8
     weights), dual GEMMs at d_ff 8960-27392, logits, and decode attention
     at groups of 6, 4, 48 and 1 query heads a KV head, one-row, paged and
     multi-row, with batch invariance at groups 6 and 48; the moe family's
     batched GEMM and dual GEMM over expert banks (mixtral-8x22b's E = 8 at
     M = 4 and 160, arctic-480b's E = 128 at M = 4 and 8, bf16; E = 4 in
     f32), each expert equal to the 2-D kernel's output bit for bit, an
     expert's rows at M = 4 equal at M = 20, torch.bmm the down
     projection's yardstick; decode attention at mixtral's 48/8 heads with
     its 4096 window over 6144 keys (one-row, paged, and the multi-row
     form of a verify step, dense and paged) and at arctic's group of 7
     (56/8: one-row, paged, multi-row, batch invariance); the paper's
     tiled GEMM (f32 and bf16, with their TFLOP/s beside torch.matmul's)
     and naive GEMM at
     4096^2, f32 against the f64 product, and add, sub, mul and axpy bit
     for bit;
     the gradient of dense_q (its autograd Function: the int8-weight
     kernel's forward, the backward's GEMMs on the tiled kernel) at
     qwen3-0.6b's down projection, 2048 rows, against autograd of the
     plain dequantized composition on the card, timed beside it;
     the bf16 GEMM also at training's shapes, 2048 rows, in all four
     layouts (qwen3-0.6b's, mamba2-2.7b's and zamba2-1.2b's widths, the
     in_proj_bc GEMMs of N = 336 and 192 among them), the dual GEMM at
     2048 rows (qwen3-0.6b's and zamba2-1.2b's) beside a GEMM-only
     yardstick, training attention at zamba2-1.2b's shared block, 32
     heads of 64, and SSD at training's batch of 4 x 512; the batched
     GEMM in the three layouts a bank's training reads (the forward, dX =
     g W^T and dW = X^T g on transpose views, in place) at mixtral-8x22b's
     640 slots an expert (gate/up and down banks) and arctic-480b's E =
     128 at 32, bf16, and at E = 4 in f32, each expert equal to the 2-D
     kernel's output bit for bit, beside torch.bmm; the non-causal flash
     backward at whisper-tiny's training shapes, the encoder's 4 x 1500
     and cross-attention's 448 queries over 1500 keys, beside SDPA's
     forward and backward less its forward), with the max error
     beside its tolerance, and the median time of the kernel, the plain version and one PyTorch library call,
     timed in turns with only the card's time inside each event pair,
     beside the least time the card could take (from the op's charge,
     `roofline.analysis`: its compulsory bytes and the products its mask
     keeps); a bf16 page pool must
     give the dense decode kernel's bits; the decode kernels' multi-row
     form (a verify step: 4 slots x 5 rows, dense, bf16 and int8 pools)
     against its plain version, each row equal to the one-row kernel at
     its position bit for bit;
  4. the dense slice at full width: qwen3-0.6b (28 layers, random weights
     from a seed) served by the engine on 4 slots to 8 requests, its
     decode and prefill-remainder steps replays of CUDA graphs captured
     at construction (the capture time and the graphs' memory printed),
     with every kernel's launches counted over that run (a replay counts
     what its capture launched); one replay at 4 busy slots against an
     eager decode step on a clone of the engine's state, bit for bit; a
     torch.profiler trace of decode steps at 4 busy slots (the card's
     busy time a step, by kernel, against the step's wall time and the
     decode p50; one graph launch a step and no kernel wrapper called;
     each kernel of the step must show in it); then two requests whose
     engine streams must equal whole-prompt prefill plus batch-1 decode;
  5. the paged slices at full width: phase 4's trace on a bf16 page pool
     must give phase 4's streams bit for bit; a prefix-heavy chat trace on
     an int8 page pool with int8 weights (prefix pages shared), with
     exact launch counts, speed, memory and the pool's report, a replay
     against the eager step and a trace as phase 4's; and that
     configuration's streams at 4 slots equal to each request alone;
  6. the request surface at full width (qwen3-0.6b, 28 layers, bf16):
     (a) speculative decoding, greedy, phase 4's 8 requests on 4 slots,
     spec_k 4, the target as its own draft on the dense cache and a bf16
     pool, and a draft of other weights (seed 1) on the dense cache (its
     run on the pool is cut for time): every stream equals phase 4's,
     the self-draft accepts every proposal and the other draft not all,
     each request's target cache rows equal the plain engine's bit for
     bit; the verify launches a round,
     the round's p50 beside phase 4's decode step and a round's logits
     copy; (b) one paged run of a bursty trace (priorities 0/1) on a pool
     that forces preemption, on a clock of one unit a step: a waiter
     expired by its deadline, a waiting and an active request cancelled,
     an eos token; every finished stream equals its request alone and
     every page returns; twice with a temperature sampler over the top
     50: the same streams, each token in its row's top 50; then on the
     wall clock: tok/s, time to first token and the deadline miss rate;
     (c) chaos: phase 4's 8 requests on 4 slots over a bf16 page pool
     under one scripted FaultInjector (a NaN logits row, a poisoned
     write page, kernel faults at two steps: a retry, then the rebuild
     of the captured steps with 4 slots busy; a slow step; a denied
     admission: a preemption and its resume): no crashed step, the two
     poisoned requests alone quarantined, every other stream phase 4's,
     a straggler flagged, every page back, the replay after the rebuild
     launching what it did before and calling no kernel wrapper, its
     seconds, graph pools and memory_allocated before and after, decode
     p50/p99 beside phase 4's; (d) the target's own weights as an int8
     draft (`draft_quant="int8"`) on the dense cache: phase 4's streams,
     exact launch counts (matmul_q in the draft's graphs and prefills),
     acceptance and round p50 beside the bf16 self-draft's;
  7. training at full width: 8 donated AdamW steps of qwen3-0.6b (f32
     params, bf16 activations, each block rematerialised) at batch 4 x
     512 tokens, supervised (`distributed.Supervisor`): a checkpoint of
     the state every 4 steps without blocking (`checkpoint.Checkpointer`,
     keep 1, in a directory under build/ removed after), a failure
     injected before step 6, the step-4 checkpoint restored into the
     state's own tensors and steps 4 and 5 run again, each with its
     first run's loss and grad norm, and the state after it, bit for bit
     (the free disk, each save's and the restore's bytes and seconds
     printed); exact launch counts a step run (the recompute's included),
     finite losses and grad norms, a falling loss, speed, memory and a
     torch.profiler trace of a step; the first 4 steps without remat from
     the same state, step 0's loss equal bit for bit, both peaks and
     steady step times; the first 2 steps again through the plain
     versions on the card, step 0 held to the kernels' (the 4 steps with
     only the dual GEMM through its plain version, and earlier 8, 4 and
     8 steps, cut for time: their findings stand in PERF.md); then a
     whole step at depth 2 in f32, batch 1 x 256,
     on the card against the same step on the CPU;
  8. training the Mamba-2 families at full width: zamba2-1.2b (36 layers
     in 6 segments, lora_b from a seed) and mamba2-2.7b (64 layers), f32
     params, bf16 activations, 16 donated AdamW steps at batch 4 x 512
     (mamba2's peak is ~48 GiB), each Mamba-2 layer rematerialised: exact
     launch counts a step (the recompute's included), finite losses whose
     mean over the last 4 steps lies below the mean over the first 4
     (`loss_falls`: over 8 steps a last-against-first gate passed or
     failed with the weights' draw), speed, memory, a trace of a step
     with the plain SSD backward as a group of its own, zamba2's first 2
     steps without remat from the same state (step 0's loss equal bit for
     bit, its grad norm within rtol 1e-5, both peaks and steady step
     times), and the first step of each through the plain versions on the
     card, its loss and grad norm within rtol 1e-3 of the kernels' (cut
     for time from 8, then 4, steps without remat and 4, then 2, plain
     ones, mamba2's steps without remat and both whole f32 steps at depth
     2 against the CPU: their findings stand in PERF.md, and
     tests/test_torch_cuda.py holds the depth-2 steps on the card); the
     weights of phases 8-10 and 14 are drawn on the card (the host's
     generator took 41 s for mamba2's alone);
  9. Mamba-2 serving at full width: mamba2-2.7b (64 layers, random
     weights from a seed) served by the engine on 4 slots to 8 requests
     whose prompts take every prefill branch, with exact launch counts
     (the SSD kernel in every admission prefill), each stream equal to
     the request served alone at batch 1 (by a 1-slot engine, as in
     phases 10 and 11: cut for time from eager steps, some 4,000 small
     launches each), speed, memory, a replay against the eager step and a
     torch.profiler trace of decode steps as phase 4's, and of a
     512-token prefill; the memory back after the engine goes; the same
     trace with int8 weights (matmul_q counted exactly, each stream equal
     to the request alone, the decode p50 beside the bf16 run's; its
     replay and trace cut for time); then a depth-2 prefill and decode in
     f32 on the card against the same on the CPU;
  10. hybrid serving at full width: zamba2-1.2b (36 Mamba-2 layers in 6
     segments, one shared attention block with a LoRA a segment, random
     weights and lora_b from seeds) served by the engine on 4 slots to 8
     requests of 64-512 tokens that take every prefill branch, in bf16
     and with int8 weights: exact launch counts (ssd in every admission
     prefill, flash_decode at D = 64 in every step; matmul_q with int8),
     each stream equal to the request alone at batch 1 (a 1-slot
     engine), a replay against the eager step and a trace of decode steps
     (bf16 only; the int8 run's cut for time), decode p50 and p99, time
     to first token, peak memory, the capture time and graph pools, and
     the memory back after each engine; a rebuild run on the bf16
     weights: 4 of those requests under kernel faults at two decode
     steps, so the captured steps are rebuilt with every Mamba state
     busy: each stream the fault-free run's, the fault-free launch
     counts, no kernel wrapper called after the rebuild; then a depth-2 (two segments)
     prefill and decode in f32 on the card against the CPU;
  11. the dense configs and vlm at full width, random weights drawn on
     the card and held in bf16, the QKV biases random: qwen2-vl-2b (28
     layers, 12/2 heads, QKV biases, M-RoPE) served on 4 slots to 8
     requests of 64-512 tokens, 32 generated each, on the dense cache,
     a bf16 page pool (the same streams) and as a speculative target with
     itself as the draft (every proposal accepted, the same streams); a
     multimodal prompt (a 16 x 16 image's patch embeddings at (t, h, w)
     positions between text) through prefill and decode at depth 2 in
     f32 on the card against the CPU; granite-3-8b (40 layers, full
     depth) in bf16 and with int8 weights, granite-20b (MQA: 48 query
     heads over 1 KV head) and qwen1.5-32b (MHA, QKV biases; and int8
     weights) at 8 layers, 4 requests each. Each run: exact launch counts
     and the bias epilogue's, each stream equal to its request alone at
     batch 1, a replay against the eager step, a trace, decode p50 and
     p99, time to first token, peak memory and capture time;
  12. the moe family at full width, random weights drawn on the card in
     bf16 (the router f32): mixtral-8x22b at 4 of its 56 layers (20 GB,
     cut for the run's time) serving phase 4's trace on the dense cache and a bf16 page pool (the
     same streams), greedy speculative decoding with mixtral as its own
     draft (k = 4, 4 slots, the dense cache: the verify graph's launches,
     every round's emitted tokens the greedy rule's on its verify logits,
     a round against an eager verify_step bit for bit and against the
     plain versions on the card, each round's dropped fraction,
     acceptance and round p50; the requests whose verify rows dropped
     nothing keep the dense streams; then 1 slot at k = 3, where no
     round can drop, on the dense cache and a bf16 pool: the dense
     streams, every proposal accepted, the multi-row decode's launches a
     round), one request of 4,608 prompt tokens past its 4096
     window (its stream equal to eager prefill and decode), and int8
     weights on an int8 pool (4 requests); arctic-480b at 2 of its 35
     layers (55.6 GB), 4 requests. Each run: exact launch counts (one
     batched dual GEMM and one batched GEMM a layer a step, the f32 router
     GEMM), each stream equal to its request on a 1-slot engine, a replay
     against the eager step, a trace, decode p50 and p99, time to first
     token, peak memory, the memory back after each engine and each
     model; then both at the reduced widths
     and depth 2 in f32 on the card against the CPU (the same routing);
  13. whisper-tiny (encdec) at full width and depth (4 encoder and 4
     decoder layers, d 384, 6 heads of 64, 1500 encoder frames), random
     weights drawn on the card in bf16 with random biases: 8 requests on
     4 slots, each with its own 1500 x 384 frames, prompts of 8-192
     tokens, 48 generated, in bf16 and with int8 weights. Each run: an
     eager admission's launches by part (the encoder: 24 GEMMs and 4
     non-causal flash forwards; the cross K/V: 8 GEMMs; the decoder),
     exact launch counts (flash_attention at causal=False in every
     admission, flash_decode twice a decoder layer a step: self and cross
     over the 1500 encoder keys; bias_gelu and bias flushes; matmul_q
     with int8), each stream equal to its request alone (a 1-slot
     engine), a replay against the eager step, a trace, decode p50 and
     p99, time to first token, peak memory and capture time; then a
     prefill and 4 decode steps at full width in f32 on the card against
     the CPU;
  14. training the encdec, vlm and moe families at full width (f32
     params, bf16 activations, remat "full", 16 donated AdamW steps, lr
     1e-3 cosine, `loss_falls`; exact launch counts a step, speed,
     memory, a trace of a step): whisper-tiny at full depth, 4 x 448
     tokens with 4 x 1500 x 384 frames a step, then a step in f32 at
     full size against the CPU; qwen2-vl-2b at full depth (weights drawn
     on the card), 4 x 512 tokens with a 16 x 16 image span a row (patch
     embeddings, (t, h, w) positions, labels -1 at the patches), then
     depth 2 in f32 against the CPU; mixtral-8x22b at full width and 1
     of its 56 layers (weights drawn on the card; its router losses and
     dropped fraction printed), the banks' backward on the batched
     GEMM's transposed layouts, step 0 with remat "none" (its loss bit
     for bit) and through the plain versions on the card (within 1e-3);
  15. the paper's experiment at its size, 4096^2: Table 2 through the
     measurement `launch.paper` prints (`benchmarks.common.measure`: float,
     double and complex-float through the naive kernel, the GEMM
     chokepoint (the tiled kernel; f64 the plain f64 product) and
     torch.matmul, each checked against the f64 product, beside the
     paper's seconds; the naive/tiled ratio beside the paper's 3.0x), Fig 9 through `benchmarks.bench_add`'s
     (add, sub and axpy in GB/s beside 3.35 TB/s), with exact launch
     counts; then the roofline model of the paper's cards and the H100;
  16. tuned tiles at full width (`repro_torch.tuning`): qwen3-0.6b's
     decode (4 slots), prefill (batch 1 over the prompts' buckets) and
     training (4 x 512, the backward's GEMMs) shapes swept into a
     temporary cache by `warm_start(autotune=True)` on the clock phase
     3's tables read (`tuning.timing`), each shape in the layouts the
     step runs it in, its static instance and winner timed in the same
     turns, the sweep's seconds, a second warm_start that hits every
     shape; every candidate of every tuned GEMM shape the static plan's
     output bit for bit in each layout; a second cache whose winners are
     forced off the static plans; a serve (4 slots, 4 requests, 16
     tokens) under the static plans, the sweep's winners and the forced
     ones with the same streams and exact launch counts, the decode
     p50s and the GEMM shapes each served off its static plan (the
     forced run's prefill and decode shapes among them); a train step
     under each cache with phase 7's step 0 loss and grad norm bit for
     bit;
  17. the roofline of a step (`roofline.counter`, `roofline.analysis`):
     one eager run of each of these steps, counted where the phase that
     ran it left it (its captured graph's replays are not counted):
     qwen3-0.6b's decode step at 4 slots (phase 4), an admission prefill
     and its train step with remat "full" and "none" (phase 7),
     mamba2-2.7b's decode (phase 9) and train steps (phase 8),
     mixtral-8x22b's decode step at 4 layers (phase 12) and
     whisper-tiny's (phase 13); each step's report (compute and memory
     terms, bound, useful ratio, mfu_roofline), its top 5 charges, its
     measured time from that phase, its share of the roofline (the
     larger term over that time) and its mfu (model FLOPs over that time
     over the bf16 peak). Each kernel launch of a counted run must be
     charged once; remat "full" must count 1.25x-1.45x the FLOPs of
     "none" over the blocks it recomputes (the step less the counted
     logits GEMMs), and over the whole step the ratio a CPU count of
     the same step gives (1.2332x: the logits lie outside the remat);
  18. distributed (`core.distributed`, `launch.train`, `launch.dryrun`;
     one card, so no multi-card time): (a) `sharded_matmul` in a NCCL
     world of 1, each schedule at the paper's 4096^2 in bf16 and f32, bit
     for bit the GEMM chokepoint's; (b) the local GEMMs each rank of a
     4-rank schedule runs (ring: 4 of (1024, 1024, 4096) a rank, the K
     blocks in the reference's order; row; column), launched on the card
     and combined in the schedule's order, held to the whole product
     (max |err| within 2^-7 of its largest entry in bf16, 1e-4 in f32),
     each shard GEMM's time beside `comm_model_bytes` over NVLink (a
     model from the data sheet, not measured); (c) the train launcher's
     entry at full width, `--compress --model-parallel 1`, 4 steps of
     qwen3-0.6b at 4 x 512: step 0's loss equal to phase 7's uncompressed
     step 0 bit for bit, exact launch counts, finite losses; (d) the
     dry-run of qwen3-0.6b x train_4k on a fake 16x16 process group:
     n_devices 256, a collective term above 0, its summary line;
  19. a JSON line of the kernels (each with its launches on every main
     path, and the batched GEMM's transposed layouts and the non-causal
     backward as `forms`), the card line, and the result line.
"""

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


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
    t0 = time.perf_counter()
    smoke = Smoke(torch)
    for phase in (smoke.phase_card, smoke.phase_build, smoke.phase_kernels,
                  smoke.phase_serve, smoke.phase_trace, smoke.phase_batching,
                  smoke.phase_paged, smoke.phase_spec, smoke.phase_train,
                  smoke.phase_train_vs_cpu, smoke.phase_train_recurrent,
                  smoke.phase_mamba, smoke.phase_mamba_vs_cpu,
                  smoke.phase_hybrid, smoke.phase_hybrid_vs_cpu,
                  smoke.phase_dense_configs, smoke.phase_moe,
                  smoke.phase_encdec, smoke.phase_train_families,
                  smoke.phase_paper, smoke.phase_tuning,
                  smoke.phase_roofline, smoke.phase_distributed):
        t = time.perf_counter()
        phase()
        print(f"      ({phase.__name__}: {time.perf_counter() - t:.1f} s; "
              f"{time.perf_counter() - t0:.0f} s since the start)")
    print(f"[19/19] result ({time.perf_counter() - t0:.0f} s since the "
          f"start)")
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
        self.host_params = {}  # config name -> its seeded params on the host
        self.rooflines = []    # the counted steps (`_count_step`)

    # -- 1. card ------------------------------------------------------
    def phase_card(self):
        torch = self.torch
        print(f"[1/19] card: {card_line()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"      torch {torch.__version__} cuda {torch.version.cuda}; "
              f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
              f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
        props = torch.cuda.get_device_properties(0)
        l2 = getattr(props, "L2_cache_size", None)
        chip = self.chip
        print(f"      L2 {l2} bytes by the device's properties, "
              f"{chip.l2_bytes} by hw.H100 (data sheet); device memory "
              f"{props.total_memory} bytes ({chip.hbm_bytes} by the data "
              f"sheet); {props.multi_processor_count} SMs "
              f"({chip.sm_count} by the data sheet)")
        assert l2 is None or l2 == chip.l2_bytes, (l2, chip.l2_bytes)

    # -- 2. build -----------------------------------------------------
    def phase_build(self):
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        libs = _build.build_all()
        print(f"[2/19] build: {sorted(libs)} from "
              f"{_build.CSRC.relative_to(ROOT)} in "
              f"{time.perf_counter() - t0:.1f} s (nvcc "
              f"{' '.join(_build.NVCC_FLAGS)})")
        for name in sorted(libs):
            for line in _build.build_log(name).splitlines():
                if "registers" in line or "bytes stack frame" in line:
                    print(f"      {name}: {line.strip()}")

    # -- 3. kernels against their plain versions ------------------------
    def _time_turns(self, fns, n=50, warmup=3, chunk=5):
        """Median ms of each callable in `fns` over n rounds run in turns,
        by the clock the autotuner reads (`tuning.timing.time_turns`:
        CUDA events, L2 flushed before each call, card time only)."""
        from repro_torch.tuning import timing
        return timing.time_turns(fns, device=self.dev, n=n, warmup=warmup,
                                 chunk=chunk)

    def _charge(self, run_kernel):
        """The work of one call of `run_kernel`, its op's charge
        (`roofline.analysis`, through `roofline.counter`): the compulsory
        bytes, and the FLOPs of the products the mask keeps (`kept_flops`)
        that the bound counts, the least the card could do. The call must
        be one charged op and nothing else that moves bytes."""
        from repro_torch.roofline import analysis, counter
        with counter.count() as c:
            run_kernel()
        (kernel, n), = c.calls.items()
        assert n == 1 and c.hbm_bytes == c.tagged_bytes[kernel], \
            (c.calls, c.top_charges(3))
        return analysis.Charge(kernel, c.flops, c.kept_flops, c.hbm_bytes,
                               c.charges[-1][1])

    def _case(self, kernel, label, run_kernel, run_plain, run_library,
              dtype, tol, reference=None, n_time=30, peak=None, note="",
              charge=None):
        """Compare, then time. tol = (atol, rtol) on |kernel - plain|, or
        a list of them for a kernel of several outputs. run_library: a
        callable to time, or a time measured by the caller, or None.
        reference: a callable whose result (of a wider dtype) the kernel
        is held against in place of the plain version's. peak: the FLOP/s
        of the kernel's route, where it is not the card's rate for dtype;
        note: printed at the end of the line. The bound's bytes and FLOPs
        are `charge`'s (a `roofline.analysis.Charge`: its bytes and kept
        FLOPs), by default the op's own charge for this call
        (`_charge`)."""
        torch = self.torch
        charge = charge or self._charge(run_kernel)
        nbytes, flops = charge.hbm_bytes, charge.kept_flops
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
            # a slice of dim 0 at a time: a bank-sized output's f32 copies
            # would not fit beside it
            rows = max(1, (1 << 28) // max(1, got[0].numel())) \
                if got.dim() else 1
            for gs, ws in zip(got.reshape(-1, *got.shape[1:]).split(rows),
                              want.reshape(-1, *want.shape[1:]).split(rows)):
                g, w = gs.to(wide), ws.to(wide)
                assert torch.isfinite(g).all(), \
                    f"{kernel} {label}: non-finite output"
                err = (g - w).abs()
                bad = err > atol + rtol * w.abs()
                max_err = max(max_err, err.max().item())
                assert not bad.any(), (f"{kernel} {label}: {int(bad.sum())} "
                                       f"elements off, max |err| "
                                       f"{err.max().item():g} (atol {atol:g} "
                                       f"rtol {rtol:g})")
                del g, w, err, bad
        atol, rtol = tols[0]
        timed = [run_plain, run_kernel] + ([run_library]
                                           if callable(run_library) else [])
        plain_ms, ms, *lib = self._time_turns(timed, n=n_time)
        lib_ms = lib[0] if lib else run_library
        t_bytes = nbytes / self.chip.hbm_bw * 1e3
        t_ops = flops / (peak or self.chip.peak_flops(
            getattr(torch, dtype).itemsize)) * 1e3
        row = dict(label=label, max_abs_err=max_err, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        self.results.setdefault(kernel, []).append(row)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        rate = f"  {flops / ms / 1e9:.1f} TFLOP/s" \
            if row["bound_by"] == "operations" else ""
        print(f"      {kernel:19s} {label:44s} err {max_err:.2e} "
              f"(atol {atol:g} rtol {rtol:g})  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f}  library {lib}  bound {row['bound_ms']:.4f} "
              f"({row['bound_by']}){rate}{note}")

    def phase_kernels(self):
        torch = self.torch
        from repro_torch.kernels import ops, ref
        F = torch.nn.functional
        print("[3/19] kernels against their plain versions (median of 30, "
              "L2 flushed, in turns, card time only)")
        gen = torch.Generator(device=self.dev).manual_seed(0)

        def randn(*shape, dtype, scale=1.0):
            x = torch.randn(shape, generator=gen, device=self.dev) * scale
            return x.to(dtype)

        tols = {torch.bfloat16: (1e-3, 2 ** -7), torch.float32: (1e-4, 1e-4)}
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
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
                kw = {}
                if ep == "residual":
                    kw["residual"] = randn(m, n, dtype=dtype)
                elif ep != "none":
                    kw["bias"] = randn(n, dtype=dtype)
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
                    lib, dname, tol)
            # the logits: x @ W_emb^T, W as an [N, K] operand, f32 out
            m, k, n = 4, 1024, 152064
            x = randn(m, k, dtype=dtype)
            w = randn(n, k, dtype=dtype, scale=k ** -0.5)
            self._case(
                "matmul", f"{dname} M={m} K={k} N={n} [N,K] B, f32 out",
                lambda: ops.matmul(x, w.t(), out_dtype=torch.float32),
                lambda: ref.fused_matmul_ref(x, w.t(), torch.float32),
                lambda: torch.matmul(x, w.t()),
                dname,
                tols[torch.float32])
            del w
            if dtype == torch.bfloat16:
                self._kernels_matmul_training(randn, tols)
                self._kernels_dense_q_grad(randn)
            # -- gated_matmul: the SwiGLU gate/up at decode, prefill and
            #    (bf16) training's 4 x 512 tokens, qwen3-0.6b's and (bf16,
            #    training) zamba2-1.2b's shared SwiGLU (d_ff 8192)
            shapes = [(m, 1024, 3072) for m in (4, 256)]
            if dtype == torch.bfloat16:
                shapes += [(2048, 1024, 3072), (2048, 2048, 8192)]
            for m, k, n in shapes:
                a = randn(m, k, dtype=dtype)
                wg = randn(k, n, dtype=dtype, scale=k ** -0.5)
                wu = randn(k, n, dtype=dtype, scale=k ** -0.5)
                self._case(
                    "gated_matmul", f"{dname} M={m} K={k} N={n}",
                    lambda a=a, wg=wg, wu=wu: ops.gated_matmul(a, wg, wu),
                    lambda a=a, wg=wg, wu=wu: ref.gated_matmul_ref(a, wg, wu),
                    None, dname, tol, n_time=20 if m == 2048 else 50)
                if m == 2048:
                    wgu = torch.cat([wg, wu], 1)
                    ms, = self._time_turns([lambda: torch.matmul(a, wgu)],
                                           n=20)
                    print(f"      gated_matmul yardstick, GEMM only (no "
                          f"silu(g)*u; not the row's library call): "
                          f"torch.matmul(A, cat([Wg, Wu], 1)) M={m} K={k} "
                          f"N={2 * n}: {ms:.4f} ms, "
                          f"{4 * m * n * k / ms / 1e9:.1f} TFLOP/s")
                    del wgu
            # -- flash_decode: 4 slots, one idle, against a 2048-deep cache,
            #    at qwen3-0.6b's heads and at zamba2's (32 of 64, one query
            #    head a KV head)
            b_, tk = 4, 2048
            pos_list = [-1, 0, 700, 2047]
            pos = torch.tensor(pos_list, dtype=torch.int32, device=self.dev)
            for h, hkv, d, windows in ((16, 8, 128, (None, 512)),
                                       (32, 32, 64, (None,))):
                q = randn(b_, 1, h, d, dtype=dtype)
                kc = randn(b_, tk, hkv, d, dtype=dtype)
                vc = randn(b_, tk, hkv, d, dtype=dtype)
                for window in windows:
                    lo = [max(0, p - window + 1) if window else 0
                          for p in pos_list]
                    mask = torch.zeros((b_, 1, 1, tk), dtype=torch.bool,
                                       device=self.dev)
                    for i, p in enumerate(pos_list):
                        mask[i, ..., lo[i]:p + 1] = True
                    self._case(
                        "flash_decode",
                        f"{dname} B={b_} H={h} Hkv={hkv} D={d} Tk={tk} "
                        f"window={window}",
                        lambda q=q, kc=kc, vc=vc, w_=window: ops.flash_decode(
                            q, kc, vc, pos=pos, window=w_),
                        lambda q=q, kc=kc, vc=vc, w_=window:
                            ref.attention_fwd_ref(q, kc, vc, window=w_,
                                                  q_offset=pos),
                        lambda q=q, kc=kc, vc=vc, m_=mask: _sdpa(
                            torch, F, q, kc, vc, m_),
                        dname, tol, note="; bound: + the pos vector's bytes")
                del q, kc, vc
        self._kernels_hybrid(randn, tols[torch.bfloat16])
        self._kernels_dense_configs(randn, tols[torch.bfloat16])
        self._kernels_moe(randn, tols)
        self._kernels_moe_training(randn, tols)
        self._kernels_encdec(randn, tols[torch.bfloat16])
        self._kernels_encdec_training(randn, tols)
        self._kernels_int8_and_paged(randn, tols[torch.bfloat16])
        self._kernels_decode_rows(randn, tols[torch.bfloat16])
        self._kernels_attention(randn, tols)
        self._kernels_ssd(gen, tols)
        self._kernels_paper(randn, tols)

    def _kernels_matmul_training(self, randn, tols, m=2048):
        """The bf16 GEMM at training's and a long prefill's shapes (4 x 512
        tokens), in every layout the step runs: qwen3-0.6b's up projection,
        down projection with its residual, tied-embedding logits (W as an
        [N, K] operand, f32 out), an input gradient (W^T: B as [N, K]) and
        a weight gradient (a^T g: A as [K, M], K the tokens); mamba2-2.7b's
        in_proj and out_proj, the input gradient of in_proj and the weight
        gradients of both, in_proj_bc (N = 2GN + H = 336, no multiple of
        the tile) with its input gradient (K = 336) and weight gradient,
        and the untied lm_head's logits (f32 out); zamba2-1.2b's Mamba
        in_proj, in_proj_bc (N = 192) and out_proj (the shared in_proj's
        K = 4096 too), the shared block's Q/K/V/O, down projection with
        its residual and LoRA pair, the input and weight gradients of
        in_proj, in_proj_bc and the down projection, and the lm_head's
        logits; each beside torch.matmul (addmm with the residual) in
        turns."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        bf16, f32 = torch.bfloat16, torch.float32
        # (label, (M, K, N), A as [K, M], B as [N, K], epilogue, out dtype)
        cases = [("up", (m, 1024, 3072), False, False, "none", bf16),
                 ("down + residual", (m, 3072, 1024), False, False,
                  "residual", bf16),
                 ("logits, [N,K] B, f32 out", (m, 1024, 152064), False, True,
                  "none", f32),
                 ("dX of up, [N,K] B", (m, 3072, 1024), False, True, "none",
                  bf16),
                 ("dW of up, [K,M] A", (1024, m, 3072), True, False, "none",
                  bf16),
                 ("mamba2 in_proj", (m, 2560, 10240), False, False, "none",
                  bf16),
                 ("mamba2 out_proj", (m, 5120, 2560), False, False, "none",
                  bf16),
                 ("dX of mamba2 in_proj, [N,K] B", (m, 10240, 2560), False,
                  True, "none", bf16),
                 ("dW of mamba2 in_proj, [K,M] A", (2560, m, 10240), True,
                  False, "none", bf16),
                 ("dW of mamba2 out_proj, [K,M] A", (5120, m, 2560), True,
                  False, "none", bf16),
                 ("mamba2 in_proj_bc", (m, 2560, 336), False, False, "none",
                  bf16),
                 ("dX of mamba2 in_proj_bc, [N,K] B", (m, 336, 2560), False,
                  True, "none", bf16),
                 ("dW of mamba2 in_proj_bc, [K,M] A", (2560, m, 336), True,
                  False, "none", bf16),
                 ("mamba2 lm_head logits, f32 out", (m, 2560, 50432), False,
                  False, "none", f32),
                 ("zamba2 Mamba in_proj", (m, 2048, 8192), False, False,
                  "none", bf16),
                 ("zamba2 in_proj_bc", (m, 2048, 192), False, False, "none",
                  bf16),
                 ("zamba2 Mamba out_proj, shared in_proj", (m, 4096, 2048),
                  False, False, "none", bf16),
                 ("zamba2 Q/K/V/O", (m, 2048, 2048), False, False, "none",
                  bf16),
                 ("zamba2 down + residual", (m, 8192, 2048), False, False,
                  "residual", bf16),
                 ("zamba2 LoRA a", (m, 2048, 32), False, False, "none", bf16),
                 ("zamba2 LoRA b", (m, 32, 2048), False, False, "none", bf16),
                 ("dX of zamba2 Mamba in_proj, [N,K] B", (m, 8192, 2048),
                  False, True, "none", bf16),
                 ("dW of zamba2 Mamba in_proj, [K,M] A", (2048, m, 8192),
                  True, False, "none", bf16),
                 ("dX of zamba2 in_proj_bc, [N,K] B", (m, 192, 2048), False,
                  True, "none", bf16),
                 ("dW of zamba2 in_proj_bc, [K,M] A", (2048, m, 192), True,
                  False, "none", bf16),
                 ("dX of zamba2 down, [N,K] B", (m, 2048, 8192), False, True,
                  "none", bf16),
                 ("dW of zamba2 down, [K,M] A", (8192, m, 2048), True, False,
                  "none", bf16),
                 ("zamba2 lm_head logits, f32 out", (m, 2048, 32000), False,
                  False, "none", f32)]
        for what, (mm, k, n), a_km, b_nk, ep, out in cases:
            a = randn(k, mm, dtype=bf16).t() if a_km else randn(mm, k, dtype=bf16)
            b = randn(n, k, dtype=bf16, scale=k ** -0.5).t() if b_nk \
                else randn(k, n, dtype=bf16, scale=k ** -0.5)
            r = randn(mm, n, dtype=bf16) if ep == "residual" else None
            lib = (lambda a=a, b=b, r=r: torch.addmm(r, a, b)) if r is not None \
                else (lambda a=a, b=b: torch.matmul(a, b))
            self._case(
                "matmul", f"bfloat16 M={mm} K={k} N={n} {what}",
                lambda a=a, b=b, r=r, ep=ep, out=out: ops.matmul(
                    a, b, out_dtype=out, epilogue=ep, residual=r),
                lambda a=a, b=b, r=r, ep=ep, out=out: ref.fused_matmul_ref(
                    a, b, out, ep, residual=r),
                lib, "bfloat16", tols[out], n_time=20,
                note="" if r is None else "; bound: the residual read once "
                "(an earlier count read it twice)")
            del a, b, r

    def _kernels_dense_q_grad(self, randn, m=2048, k=3072, n=1024):
        """The gradient of dense_q (`core.gemm._DenseQ`) at qwen3-0.6b's
        down projection with its residual, 4 x 512 tokens, bf16: d x, d
        scale and d residual through the Function (the int8-weight
        kernel's forward; dx = g W^T and dw = x^T g of the dequantized
        weight on the tiled kernel's transposed layouts) against autograd
        of the plain dequantized composition on the card, each within
        2^-7 x its largest |value|; 1 matmul_q and 2 matmul launches. The
        forward and backward timed in turns (median of 20), beside the
        plain version's."""
        torch = self.torch
        from repro_torch.core import gemm, precision
        from repro_torch.kernels import ops
        bf16 = torch.bfloat16
        x, r, g = randn(m, k, dtype=bf16), randn(m, n, dtype=bf16), \
            randn(m, n, dtype=bf16)
        wq, scale = precision.quantize_int8(
            randn(k, n, dtype=torch.float32, scale=k ** -0.5))

        def grads(fn):
            leaves = [t.detach().requires_grad_() for t in (x, scale, r)]
            fn(*leaves).backward(g)
            return [t.grad for t in leaves]

        def kernel():
            return grads(lambda x_, s_, r_: gemm.dense_q(x_, wq, s_,
                                                         residual=r_))

        def plain():
            return grads(lambda x_, s_, r_: x_ @ (wq.float() * s_).to(bf16)
                         + r_)
        ops.reset_launch_counts()
        got = kernel()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts == _no_launches(matmul_q=1, matmul=2), _nonzero(counts)
        errs = []
        for name, a, b in zip(("x", "scale", "residual"), got, plain()):
            assert a.dtype == b.dtype and torch.isfinite(a).all(), name
            top = b.abs().max().item()
            errs.append((a - b).abs().max().item() / top)
            assert errs[-1] <= 2 ** -7, (name, errs[-1])
        plain_ms, ms = self._time_turns([plain, kernel], n=20)
        flops = 3 * 2 * m * k * n
        print(f"      dense_q gradient  bfloat16 M={m} K={k} N={n} int8 W "
              f"residual (qwen3-0.6b down, 4 x 512 tokens): d x, d scale, "
              f"d residual within {', '.join(f'{e:.2e}' for e in errs)} of "
              f"the plain version's max |value| (tol 2^-7); launches "
              f"{_nonzero(counts)}; forward + backward {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms")
        self.dense_q_grad = dict(ms=ms, plain_ms=plain_ms, errs=errs)

    def _kernels_hybrid(self, randn, tol, m=4):
        """The bf16 GEMMs of a zamba2 decode step (4 slots) that no other
        path runs at these widths: the Mamba in_proj (N = 8192), in_proj_bc
        (N = 2GN + H = 192) and out_proj (K = 4096), the shared block's
        in_proj (K = 2d = 4096), the LoRA pair (rank 32), the logits
        (N = 32000), and the shared SwiGLU's dual GEMM at d_ff 8192; each
        beside torch.matmul in turns."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        dtype = torch.bfloat16
        for k, n, what in ((2048, 8192, "Mamba in_proj"),
                           (2048, 192, "Mamba in_proj_bc"),
                           (4096, 2048, "Mamba out_proj, shared in_proj"),
                           (2048, 32, "LoRA a"), (32, 2048, "LoRA b"),
                           (2048, 32000, "logits, f32 out")):
            out = torch.float32 if n == 32000 else dtype
            a = randn(m, k, dtype=dtype)
            b = randn(k, n, dtype=dtype, scale=k ** -0.5)
            self._case(
                "matmul", f"bfloat16 M={m} K={k} N={n} none ({what})",
                lambda a=a, b=b, o=out: ops.matmul(a, b, out_dtype=o),
                lambda a=a, b=b, o=out: ref.fused_matmul_ref(a, b, o),
                lambda a=a, b=b: torch.matmul(a, b),
                "bfloat16", tol if out == dtype else (1e-4, 1e-4))
        k, n = 2048, 8192
        a = randn(m, k, dtype=dtype)
        wg = randn(k, n, dtype=dtype, scale=k ** -0.5)
        wu = randn(k, n, dtype=dtype, scale=k ** -0.5)
        self._case(
            "gated_matmul", f"bfloat16 M={m} K={k} N={n} (shared SwiGLU)",
            lambda: ops.gated_matmul(a, wg, wu),
            lambda: ref.gated_matmul_ref(a, wg, wu), None,
            "bfloat16", tol)

    def _kernels_dense_configs(self, randn, tol, m=4):
        """The kernels of the dense configs' and qwen2-vl-2b's decode
        steps (4 slots, bf16): each
        dense layer's GEMM, the QKV projections of qwen2-vl-2b and
        qwen1.5-32b with the bias epilogue (a bf16 bias, as the served
        params hold it; int8 weights through matmul_q too), the down
        projection with its residual, the dual GEMM at d_ff 8960, 12800,
        24576 and 27392, and the logits (qwen2-vl-2b's tied N = 152064,
        the others' [K, N] lm_head); decode attention at their groups, 6
        (12 query heads over 2 KV heads), 4 (32 over 8), 48 (MQA) and 1
        (MHA, 40 heads), one-row on the dense cache, through a bf16 page
        table and multi-row (a verify step) at qwen2-vl-2b's; and at the
        groups of 6 and 48, where a block's last pass over its staged
        rows takes 2 and the 12th of 4 query heads, each slot's row alone
        at B = 1 and in the reversed batch equal to its row in the batch,
        bit for bit."""
        torch = self.torch
        from repro_torch.core import precision
        from repro_torch.kernels import ops, ref
        dtype = torch.bfloat16
        # (name, d_model, heads, kv heads, d_ff, logits N, tied, qkv bias)
        configs = (("qwen2-vl-2b", 1536, 12, 2, 8960, 152064, True, True),
                   ("granite-3-8b", 4096, 32, 8, 12800, 49408, False, False),
                   ("granite-20b", 6144, 48, 1, 24576, 49152, False, False),
                   ("qwen1.5-32b", 5120, 40, 40, 27392, 152064, False, True))
        for name, d, h, hkv, ff, nv, tied, bias in configs:
            gemms = [(d, h * 128, "bias" if bias else "none", "Q"),
                     (d, hkv * 128, "bias" if bias else "none", "K, V"),
                     (h * 128, d, "none", "O"),
                     (ff, d, "residual", "down")]
            for k, n, ep, what in gemms:
                a = randn(m, k, dtype=dtype)
                b = randn(k, n, dtype=dtype, scale=k ** -0.5)
                kw = {}
                if ep == "residual":
                    kw["residual"] = randn(m, n, dtype=dtype)
                elif ep == "bias":
                    kw["bias"] = randn(n, dtype=dtype, scale=0.1)
                lib = {"none": lambda a=a, b=b: torch.matmul(a, b)}.get(
                    ep, lambda a=a, b=b, e=kw.get("bias",
                                                  kw.get("residual")):
                    torch.addmm(e, a, b))
                self._case(
                    "matmul", f"bfloat16 M={m} K={k} N={n} {ep} "
                    f"({name} {what})",
                    lambda a=a, b=b, kw=kw, ep=ep: ops.matmul(
                        a, b, epilogue=ep, **kw),
                    lambda a=a, b=b, kw=kw, ep=ep: ref.fused_matmul_ref(
                        a, b, dtype, ep, kw.get("bias"),
                        kw.get("residual")),
                    lib, "bfloat16", tol, n_time=20)
                if ep == "bias":
                    wq, scale = precision.quantize_int8(b.float())
                    self._case(
                        "matmul_q", f"bfloat16 M={m} K={k} N={n} int8 "
                        f"W bias ({name} {what})",
                        lambda a=a, wq=wq, s=scale, kw=kw: ops.matmul_q(
                            a, wq, s, epilogue="bias", **kw),
                        lambda a=a, wq=wq, s=scale, kw=kw:
                            ref.matmul_q_ref(a, wq, s, dtype, "bias",
                                             **kw),
                        None, "bfloat16", tol, n_time=20)
                del a, b, kw
            a = randn(m, d, dtype=dtype)
            wg = randn(d, ff, dtype=dtype, scale=d ** -0.5)
            wu = randn(d, ff, dtype=dtype, scale=d ** -0.5)
            self._case(
                "gated_matmul", f"bfloat16 M={m} K={d} N={ff} ({name})",
                lambda a=a, wg=wg, wu=wu: ops.gated_matmul(a, wg, wu),
                lambda a=a, wg=wg, wu=wu: ref.gated_matmul_ref(a, wg, wu),
                None, "bfloat16", tol, n_time=20)
            del a, wg, wu
            # the logits, f32 out: x @ W_emb^T (tied) or x @ W_lm_head
            x = randn(m, d, dtype=dtype)
            w = randn(nv, d, dtype=dtype, scale=d ** -0.5)
            w = w.t() if tied else w.t().contiguous()
            self._case(
                "matmul", f"bfloat16 M={m} K={d} N={nv} "
                f"{'[N,K]' if tied else '[K,N]'} B, f32 out ({name} logits)",
                lambda: ops.matmul(x, w, out_dtype=torch.float32),
                lambda: ref.fused_matmul_ref(x, w, torch.float32),
                lambda: torch.matmul(x, w),
                "bfloat16", (1e-4, 1e-4), n_time=20)
            del x, w
            self._decode_cases(randn, tol, h, hkv, paged=name == "qwen2-vl-2b",
                               what=name)
        for h, hkv in ((12, 2), (48, 1)):
            self._decode_batch_invariance(randn, h, hkv)

    #: (what, dtype, experts, d_model, d_ff, row counts) of `_kernels_moe`
    MOE_BANKS = (("mixtral-8x22b", "bfloat16", 8, 6144, 16384, (4, 160)),
                 ("arctic-480b", "bfloat16", 128, 7168, 4864, (4, 8)),
                 ("f32", "float32", 4, 1024, 2048, (4, 160)))
    #: (what, dtype, experts, slots an expert, K, N) of a bank in
    #: `_kernels_moe_training`: training's 4 x 512 tokens in groups of 256
    MOE_TRAIN_BANKS = (("mixtral-8x22b gate/up", "bfloat16", 8, 640, 6144,
                        16384),
                       ("mixtral-8x22b down", "bfloat16", 8, 640, 16384, 6144),
                       ("arctic-480b gate/up", "bfloat16", 128, 32, 7168,
                        4864),
                       ("f32", "float32", 4, 160, 512, 640))

    def _kernels_moe(self, randn, tols, banks=MOE_BANKS, tk=6144):
        """The moe family's kernels: the batched dual GEMM and GEMM over
        the expert banks at mixtral-8x22b's decode (E = 8, M = 4 slots an
        expert) and prefill (M = 160: a 512-token bucket's 2 groups of 80
        slots) shapes and arctic-480b's (E = 128, M = 4 and 8), bf16, and
        at E = 4 in f32; each against its plain version, each expert's
        output equal to the 2-D kernel's on its operands bit for bit, an
        expert's first 4 rows at M = 4 equal to the same rows at M = 20
        (the decode tile against the wide one), torch.bmm the down
        projection's yardstick. Then decode attention at mixtral's 48/8
        heads with its window of 4096 over 6144 keys, and at arctic's 56/8
        (a group of 7: passes of 4 and 3 query heads), one-row, through a
        bf16 pool and multi-row (mixtral's dense and through the pool: a
        verify step's rows), with its batch invariance."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        F = torch.nn.functional
        gen = torch.Generator(device=self.dev).manual_seed(7)

        def bank(e, k, n, dtype):
            """(e, k, n), each matrix drawn in f32 and cast in turn (an
            arctic bank is 8.9 GB in bf16, twice that in f32)."""
            out = torch.empty((e, k, n), dtype=dtype, device=self.dev)
            for m in out:
                m.copy_(torch.randn((k, n), generator=gen, device=self.dev)
                        * k ** -0.5)
            return out

        for what, dname, e, d, f, ms in banks:
            dtype = getattr(torch, dname)
            tol = tols[dtype]
            n_time = 10 if e > 8 else 20
            wg, wu, wd = bank(e, d, f, dtype), bank(e, d, f, dtype), \
                bank(e, f, d, dtype)
            for m in ms:
                a = randn(e, m, d, dtype=dtype)
                h = randn(e, m, f, dtype=dtype)
                self._case(
                    "gated_matmul_batched",
                    f"{dname} E={e} M={m} K={d} N={f} ({what})",
                    lambda a=a: ops.gated_matmul_batched(a, wg, wu),
                    lambda a=a: ref.gated_matmul_batched_ref(a, wg, wu),
                    None, dname, tol, n_time=n_time)
                self._case(
                    "matmul_batched", f"{dname} E={e} M={m} K={f} N={d} "
                    f"({what} down)",
                    lambda h=h: ops.matmul_batched(h, wd),
                    lambda h=h: ref.matmul_batched_ref(h, wd),
                    lambda h=h: torch.bmm(h, wd),
                    dname, tol, n_time=n_time)
                got_g = ops.gated_matmul_batched(a, wg, wu)
                got_d = ops.matmul_batched(h, wd)
                for x in range(e):
                    assert torch.equal(got_g[x], ops.gated_matmul(
                        a[x], wg[x], wu[x])), (what, m, x, "gated")
                    assert torch.equal(got_d[x], ops.matmul(h[x], wd[x])), \
                        (what, m, x, "down")
                del got_g, got_d
            a20 = randn(e, 20, d, dtype=dtype)
            h20 = randn(e, 20, f, dtype=dtype)
            assert torch.equal(
                ops.gated_matmul_batched(a20, wg, wu)[:, :4],
                ops.gated_matmul_batched(a20[:, :4].contiguous(), wg, wu)), what
            assert torch.equal(ops.matmul_batched(h20, wd)[:, :4],
                               ops.matmul_batched(h20[:, :4].contiguous(),
                                                  wd)), what
            print(f"      batched {what}: every expert's output equals the "
                  f"2-D kernel's on its operands, bit for bit, at M = "
                  f"{', '.join(map(str, ms))}; an expert's first 4 rows at "
                  f"M = 4 equal the same rows at M = 20")
            del wg, wu, wd, a, h, a20, h20
            torch.cuda.empty_cache()
        # -- decode attention: mixtral's 48/8 with its window past 4096
        #    keys, arctic's group of 7
        dtype, tol = torch.bfloat16, tols[torch.bfloat16]
        b_, window = 4, 4096
        pos_list = [-1, 100, 4500, tk - 1]
        pos = torch.tensor(pos_list, dtype=torch.int32, device=self.dev)
        h, hkv, d = 48, 8, 128
        q = randn(b_, 1, h, d, dtype=dtype)
        kc = randn(b_, tk, hkv, d, dtype=dtype)
        vc = randn(b_, tk, hkv, d, dtype=dtype)
        mask = torch.zeros((b_, 1, 1, tk), dtype=torch.bool, device=self.dev)
        for i, p in enumerate(pos_list):
            mask[i, ..., max(0, p - window + 1):p + 1] = True
        self._case(
            "flash_decode", f"bfloat16 B={b_} H={h} Hkv={hkv} D={d} Tk={tk} "
            f"window={window} (mixtral-8x22b)",
            lambda: ops.flash_decode(q, kc, vc, pos=pos, window=window),
            lambda: ref.attention_fwd_ref(q, kc, vc, window=window,
                                          q_offset=pos),
            lambda: _sdpa(torch, F, q, kc, vc, mask),
            "bfloat16", tol, n_time=20)
        del q, kc, vc, mask
        # a verify step's rows at mixtral's 48/8 and window: dense, paged
        self._decode_cases(randn, tol, 48, 8, paged=True, what="mixtral-8x22b",
                           tk=tk, window=window)
        self._decode_cases(randn, tol, 56, 8, paged=True, what="arctic-480b")
        self._decode_batch_invariance(randn, 56, 8)

    def _kernels_moe_training(self, randn, tols, banks=MOE_TRAIN_BANKS):
        """The batched GEMM in the three layouts a bank's training reads,
        at training's batch of 4 x 512 tokens in groups of 256 (mixtral-
        8x22b: E = 8 experts of 8 x 80 = 640 slots, its gate/up bank K =
        6144, N = 16384 and its down bank K = 16384, N = 6144; arctic-480b:
        E = 128 of 8 x 4 = 32 slots, its gate/up bank K = 7168, N = 4864),
        bf16, and at E = 4 in f32: the forward (row-major), dX = g W^T (W^T
        a transpose view of the bank) and dW = X^T g (X^T a view), each
        against its plain version beside torch.bmm on the same views, each
        expert's output equal to the 2-D kernel's on its operands bit for
        bit."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        gen = torch.Generator(device=self.dev).manual_seed(11)

        def bank(e, k, n, dtype):
            out = torch.empty((e, k, n), dtype=dtype, device=self.dev)
            for m in out:
                m.copy_(torch.randn((k, n), generator=gen, device=self.dev)
                        * k ** -0.5)
            return out

        for what, dname, e, m, k, n in banks:
            dtype = getattr(torch, dname)
            tol, n_time = tols[dtype], 5 if e > 8 else 10
            w = bank(e, k, n, dtype)
            x = randn(e, m, k, dtype=dtype)
            g = randn(e, m, n, dtype=dtype)
            for form, a, b in (("forward", x, w),
                               ("dX = g W^T, W^T a view", g,
                                w.transpose(1, 2)),
                               ("dW = X^T g, X^T a view", x.transpose(1, 2),
                                g)):
                em, ek = a.shape[1:]
                en = b.shape[2]
                self._case(
                    "matmul_batched", f"{dname} E={e} M={em} K={ek} N={en} "
                    f"({what} {form})",
                    lambda a=a, b=b: ops.matmul_batched(a, b),
                    lambda a=a, b=b: ref.matmul_batched_ref(a, b),
                    lambda a=a, b=b: torch.bmm(a, b),
                    dname, tol, n_time=n_time)
                got = ops.matmul_batched(a, b)
                for i in range(e):
                    assert torch.equal(got[i], ops.matmul(a[i], b[i])), \
                        (what, form, i)
                del got
            print(f"      batched {what}: in each layout every expert's "
                  f"output equals the 2-D kernel's on its operands, bit for "
                  f"bit")
            del w, x, g
            torch.cuda.empty_cache()

    def _kernels_encdec_training(self, randn, tols):
        """The flash backward at `causal=False` at whisper-tiny's training
        shapes, 4 x 6 heads of 64: the encoder (Tq = Tk = 1500 = 23 x 64 +
        28, a ragged key edge) and cross-attention (Tq = 448 decoder
        queries over the 1500 encoder keys), bf16, from the plain forward's
        o and lse; the library yardstick SDPA's forward and backward less
        its forward, no mask."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        F = torch.nn.functional
        b_, h, dh, te = 4, 6, 64, 1500
        dtype, tol = torch.bfloat16, tols[torch.bfloat16]
        for tq, what in ((te, "encoder"), (448, "cross")):
            q = randn(b_, tq, h, dh, dtype=dtype)
            k = randn(b_, te, h, dh, dtype=dtype)
            v = randn(b_, te, h, dh, dtype=dtype)
            do = randn(b_, tq, h, dh, dtype=dtype)
            o, lse = ref.flash_attention_fwd_ref(q, k, v, causal=False)
            fwd_ms, both_ms = self._time_turns([
                _sdpa_train(torch, F, q, k, v, None, causal=False),
                _sdpa_train(torch, F, q, k, v, None, do, causal=False)],
                n=20)
            self._case(
                "flash_attention_bwd", f"bfloat16 B={b_} Tq={tq} Tk={te} "
                f"H={h} Hkv={h} D={dh} not causal (whisper {what})",
                lambda: ops.flash_attention_bwd(q, k, v, o, do, lse,
                                                causal=False),
                lambda: ref.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                                    causal=False),
                both_ms - fwd_ms, "bfloat16", tol, n_time=20)
            del q, k, v, do, o, lse

    def _kernels_encdec(self, randn, tol):
        """whisper-tiny's kernels at its shapes (bf16, d 384, 6 heads of
        64): the encoder's GEMMs at M = 1500 frames (Q/K/V/O, w_in with the
        bias_gelu flush, w_out with the bias flush; one admission), the
        decode step's (M = 4) and the tied logits (N = 51968, f32 out);
        w_in's bias_gelu on int8 weights at M = 4 and 1500; the non-causal
        flash forward at the encoder's T = 1500 and at cross-attention's
        prefill (Tq = 128 against 1500 keys), beside SDPA without a mask;
        and decode attention over the 1500 encoder keys at pos 1499 (one
        slot idle), beside SDPA for one query."""
        torch = self.torch
        from repro_torch.core import precision
        from repro_torch.kernels import ops, ref
        F = torch.nn.functional
        dtype = torch.bfloat16
        d, ff, h, dh, te, nv = 384, 1536, 6, 64, 1500, 51968
        for m, k, n, ep, what in ((te, d, d, "none", "encoder Q/K/V/O"),
                                  (te, d, ff, "bias_gelu", "encoder w_in"),
                                  (te, ff, d, "bias", "encoder w_out"),
                                  (4, d, d, "none", "decode Q/K/V/O"),
                                  (4, d, ff, "bias_gelu", "decode w_in"),
                                  (4, ff, d, "bias", "decode w_out")):
            a = randn(m, k, dtype=dtype)
            b = randn(k, n, dtype=dtype, scale=k ** -0.5)
            bias = randn(n, dtype=dtype, scale=0.1) if ep != "none" else None
            kw = {} if bias is None else {"bias": bias}
            lib = {"none": lambda a=a, b=b: torch.matmul(a, b),
                   "bias": lambda a=a, b=b, e=bias: torch.addmm(e, a, b)
                   }.get(ep)
            self._case(
                "matmul", f"bfloat16 M={m} K={k} N={n} {ep} "
                f"(whisper {what})",
                lambda a=a, b=b, kw=kw, ep=ep: ops.matmul(a, b, epilogue=ep,
                                                          **kw),
                lambda a=a, b=b, kw=kw, ep=ep: ref.fused_matmul_ref(
                    a, b, dtype, ep, kw.get("bias")),
                lib, "bfloat16", tol, n_time=20)
            if ep == "bias_gelu":
                wq, scale = precision.quantize_int8(b.float())
                self._case(
                    "matmul_q", f"bfloat16 M={m} K={k} N={n} int8 W "
                    f"bias_gelu (whisper {what})",
                    lambda a=a, wq=wq, s=scale, e=bias: ops.matmul_q(
                        a, wq, s, epilogue="bias_gelu", bias=e),
                    lambda a=a, wq=wq, s=scale, e=bias: ref.matmul_q_ref(
                        a, wq, s, dtype, "bias_gelu", bias=e),
                    None, "bfloat16", tol, n_time=20)
            del a, b
        x = randn(4, d, dtype=dtype)
        w = randn(nv, d, dtype=dtype, scale=d ** -0.5)
        self._case(
            "matmul", f"bfloat16 M=4 K={d} N={nv} [N,K] B, f32 out "
            f"(whisper logits)",
            lambda: ops.matmul(x, w.t(), out_dtype=torch.float32),
            lambda: ref.fused_matmul_ref(x, w.t(), torch.float32),
            lambda: torch.matmul(x, w.t()),
            "bfloat16",
            (1e-4, 1e-4), n_time=20)
        del x, w
        k = randn(1, te, h, dh, dtype=dtype)
        v = randn(1, te, h, dh, dtype=dtype)
        for tq, what in ((te, "encoder"), (128, "cross prefill")):
            q = randn(1, tq, h, dh, dtype=dtype)
            self._case(
                "flash_attention", f"bfloat16 B=1 Tq={tq} Tk={te} H={h} "
                f"Hkv={h} D={dh} not causal (whisper {what})",
                lambda q=q: ops.flash_attention_fwd(q, k, v, causal=False),
                lambda q=q: ref.flash_attention_fwd_ref(q, k, v,
                                                        causal=False),
                lambda q=q: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
                "bfloat16",
                [tol, (1e-4, 1e-4)], n_time=20)
        b_ = 4
        q = randn(b_, 1, h, dh, dtype=dtype)
        kc = randn(b_, te, h, dh, dtype=dtype)
        vc = randn(b_, te, h, dh, dtype=dtype)
        pos = torch.tensor([te - 1, -1, te - 1, te - 1], dtype=torch.int32,
                           device=self.dev)
        mask = (pos >= 0).view(b_, 1, 1, 1).expand(b_, 1, 1, te)
        self._case(
            "flash_decode", f"bfloat16 B={b_} H={h} Hkv={h} D={dh} Tk={te} "
            f"pos [1499, -1, 1499, 1499] (whisper cross)",
            lambda: ops.flash_decode(q, kc, vc, pos=pos),
            lambda: ref.attention_fwd_ref(q, kc, vc, q_offset=pos),
            lambda: _sdpa(torch, F, q, kc, vc, mask),
            "bfloat16", tol, note="; bound: + the pos vector's bytes")

    def _decode_cases(self, randn, tol, h, hkv, paged, what, d=128, tk=2048,
                      window=None):
        """flash_decode at (h, hkv) heads of d, 4 slots against a tk-deep
        cache at pos [-1, 0, 700, tk - 5] ([-1, 100, 4500, tk - 5] with a
        `window`: each slot sees its last `window` keys); with `paged`,
        the same through a bf16 page table (whose output must be the
        dense kernel's bits) and the multi-row form (5 rows a slot,
        n_valid [5, 5, 3, 5]), dense and through the table, each row the
        one-row kernel's bits at its position."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        F = torch.nn.functional
        dtype = torch.bfloat16
        b_, ps, t = 4, 16, 5
        pos_list = [-1, 0, 700, tk - t] if window is None \
            else [-1, 100, 4500, tk - t]
        nv_list = [t, t, 3, t]
        w = window or tk

        def lo(p):                        # a query at p sees keys lo(p) .. p
            return max(0, p - w + 1)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=self.dev)
        q = randn(b_, t, h, d, dtype=dtype)
        kc = randn(b_, tk, hkv, d, dtype=dtype)
        vc = randn(b_, tk, hkv, d, dtype=dtype)
        q1 = q[:, :1].contiguous()
        mask = torch.zeros((b_, 1, 1, tk), dtype=torch.bool, device=self.dev)
        for i, p in enumerate(pos_list):
            mask[i, ..., lo(p):p + 1] = True
        win = "" if window is None else f" window={window}"
        label = f"bfloat16 B={b_} H={h} Hkv={hkv} D={d} Tk={tk}{win} ({what})"
        self._case(
            "flash_decode", label,
            lambda: ops.flash_decode(q1, kc, vc, pos=pos, window=window),
            lambda: ref.attention_fwd_ref(q1, kc, vc, window=window,
                                          q_offset=pos),
            lambda: _sdpa(torch, F, q1, kc, vc, mask),
            "bfloat16", tol, n_time=20)
        if not paged:
            return
        pp = tk // ps
        perm = torch.randperm(b_ * pp, generator=torch.Generator()
                              .manual_seed(2)).to(self.dev)
        kp = torch.empty((b_ * pp, ps, hkv, d), dtype=dtype, device=self.dev)
        vp = torch.empty_like(kp)
        kp[perm] = kc.reshape(b_ * pp, ps, hkv, d)
        vp[perm] = vc.reshape(b_ * pp, ps, hkv, d)
        table = perm.reshape(b_, pp).to(torch.int32)
        for i, (p, n) in enumerate(zip(pos_list, nv_list)):
            table[i, max(p + n - 1, -1) // ps + 1:] = -1
        assert torch.equal(ops.flash_decode_paged(q1, kp, vp, table, pos=pos,
                                                  window=window),
                           ops.flash_decode(q1, kc, vc, pos=pos,
                                            window=window)), \
            f"{what}: a bf16 pool's output != the dense cache's bits"
        self._case(
            "flash_decode_paged", f"bfloat16 bf16 pool B={b_} H={h} "
            f"Hkv={hkv} D={d} ps={ps} pp={pp}{win} ({what})",
            lambda: ops.flash_decode_paged(q1, kp, vp, table, pos=pos,
                                           window=window),
            lambda: ref.flash_decode_paged_ref(q1, kp, vp, table, pos=pos,
                                               window=window),
            None, "bfloat16", tol, n_time=20)
        n_valid = torch.tensor(nv_list, dtype=torch.int32, device=self.dev)
        rmask = torch.zeros((b_, 1, t, tk), dtype=torch.bool,
                            device=self.dev)
        for i, (p, n) in enumerate(zip(pos_list, nv_list)):
            for r in range(n if p >= 0 else 0):
                rmask[i, 0, r, lo(p + r):p + r + 1] = True
        got = ops.flash_decode(q, kc, vc, pos=pos, window=window,
                               n_valid=n_valid)
        for r in range(t):
            pr = torch.where((pos >= 0) & (r < n_valid), pos + r, -1) \
                .to(torch.int32)
            one = ops.flash_decode(q[:, r:r + 1].contiguous(), kc, vc, pos=pr,
                                   window=window)
            assert torch.equal(got[:, r], one[:, 0]), \
                f"{what}: row {r} != the one-row kernel at pos + {r}"
        self._case(
            "flash_decode_rows", f"bfloat16 B={b_} t={t} H={h} Hkv={hkv} "
            f"D={d} Tk={tk}{win} ({what})",
            lambda: ops.flash_decode(q, kc, vc, pos=pos, window=window,
                                     n_valid=n_valid),
            lambda: ref.decode_rows_ref(q, kc, vc, pos=pos, window=window,
                                        n_valid=n_valid),
            lambda: _sdpa(torch, F, q, kc, vc, rmask),
            "bfloat16", tol, n_time=20)
        if window is None:
            return
        got = ops.flash_decode_paged(q, kp, vp, table, pos=pos, window=window,
                                     n_valid=n_valid)
        assert torch.equal(got, ops.flash_decode(
            q, kc, vc, pos=pos, window=window, n_valid=n_valid)), \
            f"{what}: a bf16 pool's rows != the dense cache's bits"
        self._case(
            "flash_decode_paged_rows", f"bfloat16 bf16 pool B={b_} t={t} "
            f"H={h} Hkv={hkv} D={d} ps={ps} pp={pp}{win} ({what})",
            lambda: ops.flash_decode_paged(q, kp, vp, table, pos=pos,
                                           window=window, n_valid=n_valid),
            lambda: ref.flash_decode_paged_ref(q, kp, vp, table, pos=pos,
                                               window=window, n_valid=n_valid),
            None, "bfloat16", tol, n_time=20)

    def _decode_batch_invariance(self, randn, h, hkv, d=128, tk=2048):
        """flash_decode and flash_decode_paged (bf16 and int8 pools) at
        (h, hkv): each slot's output row at B = 4 (depths -1, 63, 700,
        2047) equals its row in the reversed batch and alone at B = 1,
        against the whole cache and its own prefix (whole pages), bit for
        bit."""
        torch = self.torch
        from repro_torch.core import precision
        from repro_torch.kernels import ops
        dtype = torch.bfloat16
        b_, ps = 4, 16
        pos_list = [-1, 63, 700, tk - 1]
        q = randn(b_, 1, h, d, dtype=dtype)
        k = randn(b_, tk, hkv, d, dtype=dtype)
        v = randn(b_, tk, hkv, d, dtype=dtype)

        def run(layout, rows, depth, seed):
            pos = torch.tensor([pos_list[i] for i in rows], dtype=torch.int32,
                               device=self.dev)
            qb = q[rows].contiguous()
            kb, vb = k[rows, :depth].contiguous(), v[rows, :depth].contiguous()
            if layout == "dense":
                return ops.flash_decode(qb, kb, vb, pos=pos)
            n, pp = len(rows), depth // ps
            perm = torch.randperm(n * pp, generator=torch.Generator()
                                  .manual_seed(seed)).to(self.dev)
            kp = torch.empty((n * pp, ps, hkv, d), dtype=dtype,
                             device=self.dev)
            vp = torch.empty_like(kp)
            kp[perm] = kb.reshape(n * pp, ps, hkv, d)
            vp[perm] = vb.reshape(n * pp, ps, hkv, d)
            table = perm.reshape(n, pp).to(torch.int32)
            kw = {}
            if layout == "int8":
                (kp, ks), (vp, vs) = (precision.quantize_kv(kp),
                                      precision.quantize_kv(vp))
                kw = dict(ks=ks.transpose(1, 2).contiguous(),
                          vs=vs.transpose(1, 2).contiguous())
            return ops.flash_decode_paged(qb, kp, vp, table, pos=pos, **kw)

        for layout in ("dense", "bf16", "int8"):
            together = run(layout, [0, 1, 2, 3], tk, 3)
            reverse = run(layout, [3, 2, 1, 0], tk, 4).flip(0)
            assert not together[0].any(), "an idle slot must give zeros"
            for i, p in enumerate(pos_list):
                assert torch.equal(reverse[i], together[i]), (layout, i)
                if p < 0:
                    continue
                shallow = -(-(p + 1) // ps) * ps
                for depth, seed in ((tk, 5), (shallow, 6)):
                    assert torch.equal(run(layout, [i], depth, seed)[0],
                                       together[i]), (h, hkv, layout, i, depth)
        print(f"      decode attention at {h} query heads over {hkv} KV heads "
              f"(a group of {h // hkv}): each slot's row alone at B = 1 "
              f"(the whole cache and its own prefix) and in the reversed "
              f"batch equals its row at B = 4, bit for bit, on the dense "
              f"cache, a bf16 pool and an int8 pool")

    def _kernels_int8_and_paged(self, randn, tol):
        """matmul_q at the int8 main path's shapes and flash_decode_paged
        on bf16 and int8 pools, bf16 activations."""
        torch = self.torch
        from repro_torch.core import precision
        from repro_torch.kernels import ops, ref
        dtype = torch.bfloat16
        # -- matmul_q: every dense layer of the int8-weight model; the
        #    down-projection carries the residual; each bias epilogue at
        #    the up-projection's shape
        cases = [(m, k, n, "none") for m in (4, 256)
                 for k, n in ((1024, 2048), (1024, 1024), (2048, 1024),
                              (1024, 3072))]
        cases += [(m, 3072, 1024, "residual") for m in (4, 256)]
        cases += [(m, 1024, 3072, ep) for m in (4, 256)
                  for ep in ("bias", "bias_gelu", "bias_silu")]
        # the int8 Mamba in_proj at decode: zamba2's and mamba2-2.7b's;
        # zamba2's shared in_proj (K = 4096) and its logits
        cases += [(4, 2048, 8192, "none"), (4, 2560, 10240, "none"),
                  (4, 4096, 2048, "none"), (4, 2048, 32000, "none")]
        for m, k, n, ep in cases:
            a = randn(m, k, dtype=dtype)
            wq, scale = precision.quantize_int8(
                randn(k, n, dtype=torch.float32, scale=k ** -0.5))
            kw = {}
            if ep == "residual":
                kw["residual"] = randn(m, n, dtype=dtype)
            elif ep != "none":
                kw["bias"] = randn(n, dtype=dtype)
            self._case(
                "matmul_q", f"bfloat16 M={m} K={k} N={n} int8 W {ep}",
                lambda a=a, wq=wq, s=scale, kw=kw, ep=ep: ops.matmul_q(
                    a, wq, s, epilogue=ep, **kw),
                lambda a=a, wq=wq, s=scale, kw=kw, ep=ep: ref.matmul_q_ref(
                    a, wq, s, dtype, ep, **kw),
                None, "bfloat16", tol)
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
            for pool, (k_, v_, kw) in {
                    "bf16": (kp, vp, {}),
                    "int8": (k8, v8, dict(ks=ks, vs=vs))}.items():
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
                    None, "bfloat16", tol)
        print("      flash_decode_paged on a bf16 pool equals flash_decode on "
              "the dense cache, bit for bit (window None and 512)")

    def _kernels_decode_rows(self, randn, tol, b_=4, t=5, tk=2048):
        """The decode kernels' multi-row form, a verify step's attention
        (4 slots x 5 rows: the pending token and 4 proposals; one slot
        idle, one with 3 real rows), bf16, dense and through a page table
        (bf16 and int8 pools), against the plain version; each row equal
        to the one-row kernel at its position bit for bit, and a bf16
        pool to the dense cache. The library yardstick is SDPA with a
        (B, 1, t, Tk) bool mask (its fully masked rows NaN there)."""
        torch = self.torch
        from repro_torch.core import precision
        from repro_torch.kernels import ops, ref
        F = torch.nn.functional
        dtype = torch.bfloat16
        h, hkv, d, ps = 16, 8, 128, 16
        pp = tk // ps
        pos_list, nv_list = [-1, 0, 700, tk - t], [t, t, 3, t]
        q = randn(b_, t, h, d, dtype=dtype)
        kc = randn(b_, tk, hkv, d, dtype=dtype)
        vc = randn(b_, tk, hkv, d, dtype=dtype)
        pos = torch.tensor(pos_list, dtype=torch.int32, device=self.dev)
        n_valid = torch.tensor(nv_list, dtype=torch.int32, device=self.dev)
        perm = torch.randperm(b_ * pp, generator=torch.Generator()
                              .manual_seed(1)).to(self.dev)
        kp = torch.empty((b_ * pp, ps, hkv, d), dtype=dtype, device=self.dev)
        vp = torch.empty_like(kp)
        kp[perm] = kc.reshape(b_ * pp, ps, hkv, d)
        vp[perm] = vc.reshape(b_ * pp, ps, hkv, d)
        table = perm.reshape(b_, pp).to(torch.int32)
        for i, (p, n) in enumerate(zip(pos_list, nv_list)):
            table[i, max(p + n - 1, -1) // ps + 1:] = -1
        k8, ks = precision.quantize_kv(kp)
        v8, vs = precision.quantize_kv(vp)
        ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
        pools = {"bf16": (kp, vp, {}), "int8": (k8, v8, dict(ks=ks, vs=vs))}
        for window in (None, 512):
            mask = torch.zeros((b_, 1, t, tk), dtype=torch.bool,
                               device=self.dev)
            for i, (p, n) in enumerate(zip(pos_list, nv_list)):
                for r in range(n if p >= 0 else 0):
                    lo = max(0, p + r - window + 1) if window else 0
                    mask[i, 0, r, lo:p + r + 1] = True
            dense = ops.flash_decode(q, kc, vc, pos=pos, window=window,
                                     n_valid=n_valid)
            rows8 = ops.flash_decode_paged(q, k8, v8, table, pos=pos,
                                           window=window, ks=ks, vs=vs,
                                           n_valid=n_valid)
            for r in range(t):
                pr = torch.where((pos >= 0) & (r < n_valid), pos + r, -1) \
                    .to(torch.int32)
                one = ops.flash_decode(q[:, r:r + 1].contiguous(), kc, vc,
                                       pos=pr, window=window)
                assert torch.equal(dense[:, r], one[:, 0]), \
                    f"row {r} != the one-row kernel at pos + {r}"
                one8 = ops.flash_decode_paged(
                    q[:, r:r + 1].contiguous(), k8, v8, table, pos=pr,
                    window=window, ks=ks, vs=vs)
                assert torch.equal(rows8[:, r], one8[:, 0]), \
                    f"int8 pool: row {r} != the one-row kernel at pos + {r}"
            assert torch.equal(ops.flash_decode_paged(
                q, kp, vp, table, pos=pos, window=window, n_valid=n_valid),
                dense), "paged bf16 pool rows != dense cache rows"
            self._case(
                "flash_decode_rows",
                f"bfloat16 B={b_} t={t} H={h} Hkv={hkv} D={d} Tk={tk} "
                f"window={window}",
                lambda w_=window: ops.flash_decode(q, kc, vc, pos=pos,
                                                   window=w_, n_valid=n_valid),
                lambda w_=window: ref.decode_rows_ref(q, kc, vc, pos=pos,
                                                      window=w_,
                                                      n_valid=n_valid),
                lambda m_=mask: _sdpa(torch, F, q, kc, vc, m_),
                "bfloat16", tol)
            for pool, (k_, v_, kw) in pools.items():
                self._case(
                    "flash_decode_paged_rows",
                    f"bfloat16 {pool} pool B={b_} t={t} H={h} Hkv={hkv} "
                    f"D={d} ps={ps} pp={pp} window={window}",
                    lambda k_=k_, v_=v_, kw=kw, w_=window:
                        ops.flash_decode_paged(q, k_, v_, table, pos=pos,
                                               window=w_, n_valid=n_valid,
                                               **kw),
                    lambda k_=k_, v_=v_, kw=kw, w_=window:
                        ref.flash_decode_paged_ref(q, k_, v_, table, pos=pos,
                                                   window=w_, n_valid=n_valid,
                                                   **kw),
                    None, "bfloat16", tol)
        print(f"      decode rows: each of the {t} rows of a slot equals the "
              f"one-row kernel at pos + r bit for bit (dense and int8 "
              f"pool), and a bf16 pool the dense cache (window None and "
              f"512)")

    def _kernels_attention(self, randn, tols):
        """flash_attention and flash_attention_bwd at the training shape
        (B=4, T=512, 16 query / 8 KV heads of 128, causal), with a window
        of 128 and at a ragged T=500, in bf16 and f32; and at zamba2-1.2b's
        shared block (32 query and KV heads of 64), bf16. The bound counts
        the unmasked (query, key) pairs only; the library yardsticks are
        SDPA's forward, and its forward + backward less its forward."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        F = torch.nn.functional
        b_ = 4
        bf16, f32 = torch.bfloat16, torch.float32
        # (dtype, H, Hkv, D, (T, window) cases): qwen3-0.6b's heads in bf16
        # and f32; zamba2-1.2b's shared block (32 heads of 64, one query
        # head a KV head), bf16
        qwen3 = ((512, None), (512, 128), (500, None))
        for dtype, h, hkv, d, shapes in ((bf16, 16, 8, 128, qwen3),
                                         (f32, 16, 8, 128, qwen3),
                                         (bf16, 32, 32, 64, ((512, None),))):
            dname = str(dtype).split(".")[-1]
            for t, window in shapes:
                q = randn(b_, t, h, d, dtype=dtype)
                k = randn(b_, t, hkv, d, dtype=dtype)
                v = randn(b_, t, hkv, d, dtype=dtype)
                do = randn(b_, t, h, d, dtype=dtype)
                pos = torch.arange(t, device=self.dev)
                mask = pos[None, :] <= pos[:, None]
                if window:
                    mask &= pos[None, :] > pos[:, None] - window
                label = (f"{dname} B={b_} T={t} H={h} Hkv={hkv} D={d} "
                         f"causal window={window}")
                sdpa = _sdpa_train(torch, F, q, k, v, None if window is None
                                   else mask)
                self._case(
                    "flash_attention", label,
                    lambda: ops.flash_attention_fwd(q, k, v, window=window),
                    lambda: ref.flash_attention_fwd_ref(q, k, v,
                                                        window=window),
                    sdpa, dname, [tols[dtype], tols[torch.float32]])
                o, lse = ref.flash_attention_fwd_ref(q, k, v, window=window)
                fwd_ms, both_ms = self._time_turns([sdpa, _sdpa_train(
                    torch, F, q, k, v, None if window is None else mask, do)])
                self._case(
                    "flash_attention_bwd", label,
                    lambda: ops.flash_attention_bwd(q, k, v, o, do, lse,
                                                    window=window),
                    lambda: ref.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                                        window=window),
                    both_ms - fwd_ms, dname, tols[dtype])
                del q, k, v, do, o, lse

    def _kernels_ssd(self, gen, tols):
        """ssd_intra_chunk against its plain version (y_diag and the chunk
        states, both f32, so f32 tolerance also for bf16 inputs), and the
        whole scan (ops.ssd: the kernel, then the inter-chunk recurrence)
        against the plain chunked scan, y in the input dtype (for bf16
        inputs, strong decays and training's batch of 4 x 512 at
        mamba2-2.7b's and zamba2-1.2b's heads). x ~ N(0, 1),
        B and C scaled so that C . B ~ N(0, 1), -a ~ U(0.01, 0.5). The
        bound is the op's charge, its bytes and kept FLOPs
        (`roofline.analysis.ssd_charge`, `ssd_intra_chunk_charge`): each
        input and output once, and the unmasked products: the causal half
        of C B^T and of S x, and the state. f32
        operands at the kernel's route, three TF32 tensor-core passes a
        product (3xTF32); bf16 ones at the card's bf16 tensor rate, one
        pass for C B^T and two for S x and the state, whose f32 side
        (S, B w) takes at most two bf16 parts; the scan's own products at
        the f32 FMA rate. The bound of the FMA route (every product at 67
        TFLOP/s) is printed beside it. No single PyTorch call computes
        SSD, so there is no library time."""
        torch = self.torch
        from repro_torch.kernels import ops, ref
        from repro_torch.kernels import ssd as kssd
        from repro_torch.roofline import analysis as an

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
                 (1, 512, 64, 1, 64, 64, 128, f32, None, False),
                 # training's batch 4 x 512, f32 inputs (mamba_apply scales
                 # x by dt in f32): mamba2-2.7b's and zamba2-1.2b's heads
                 (4, 512, 80, 1, 64, 128, 256, f32, None, False),
                 (4, 512, 64, 1, 64, 64, 128, f32, None, False)]
        for b, l, h, g, p, n, q, dtype, decay, with_state in cases:
            dname = str(dtype).split(".")[-1]
            x, a, bm, cm = inputs(b, l, h, g, p, n, dtype, decay)
            intra = an.ssd_intra_chunk_charge(x, a, bm, cm, q)
            flops = intra.kept_flops
            # C B^T's share of the intra-chunk products: one bf16 pass
            cb_flops = b * h * (l // q) * q * (q + 1) * n
            t_route = 3 * flops / self.chip.peak_flops_tf32 if dtype == f32 \
                else (2 * flops - cb_flops) / self.chip.peak_flops(2)
            fma = self.chip.peak_flops_f32

            def route(c):
                """_case's charge, peak and note for the charge c: its
                intra-chunk products at the route's rate, the rest (the
                scan's own) at the FMA rate."""
                scan = c.kept_flops - flops
                fma_ms = max(c.hbm_bytes / self.chip.hbm_bw,
                             c.kept_flops / fma) * 1e3
                return dict(charge=c,
                            peak=c.kept_flops / (t_route + scan / fma),
                            note=f"; FMA-route bound {fma_ms:.4f}")
            label = (f"{dname} B={b} L={l} H={h} G={g} P={p} N={n} "
                     f"chunk={q}" + (f" a=-{decay:g}" if decay else ""))
            if with_state:
                s0 = torch.randn((b, h, p, n), generator=gen, device=self.dev)
                self._case(
                    "ssd", label + " scan from init_state",
                    lambda: ops.ssd(x, a, bm, cm, q, init_state=s0),
                    lambda: ref.ssd_chunked_ref(x, a, bm, cm, q, s0),
                    None, "float32",
                    [tols[dtype], tols[f32]],
                    **route(an.ssd_charge(x, a, bm, cm, q, init_state=s0)))
                continue
            self._case(
                "ssd", label,
                lambda: kssd.ssd_intra_chunk(x, a, bm, cm, q),
                lambda: ref.ssd_intra_chunk_ref(x, a, bm, cm, q),
                None, "float32", tols[f32], **route(intra))
            if dtype == bf16 or decay or b == 4:
                self._case(
                    "ssd", label + " scan",
                    lambda: ops.ssd(x, a, bm, cm, q),
                    lambda: ref.ssd_chunked_ref(x, a, bm, cm, q),
                    None, "float32",
                    [tols[dtype], tols[f32]],
                    **route(an.ssd_charge(x, a, bm, cm, q)))
            del x, a, bm, cm

    def _kernels_paper(self, randn, tols, n=4096):
        """The paper's kernels at its size n = 4096: the tiled GEMM at n^2
        (f32 held to the f64 product within atol K 2^-24, as the naive
        one; bf16 to its plain version), the naive GEMM at n^2
        (f32 held to the f64 product within atol K 2^-24, K roundings of a
        partial sum of order 1; bf16 to its plain version), f64 at
        (n/4)^2 (atol K 2^-53) and a ragged f32 product; add, sub and mul
        in f32, bf16 and f64 at n^2, add at a ragged size, on unaligned
        operands and on complex64 (through the f32 view), and axpy with
        alpha a number and a tensor on the card, all bit for bit."""
        torch = self.torch
        from repro_torch.kernels import elementwise as kew
        from repro_torch.kernels import ops, ref
        from repro_torch.roofline import analysis as an
        f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
        exact = (0.0, 0.0)

        def name(dtype):
            return str(dtype).split(".")[-1]

        # the tiled GEMM at the paper's size (Table 2's "tiled" column):
        # f32 on the FMA kernel's wide tile, held to the f64 product; bf16
        # on the tensor cores
        for dtype in (f32, bf16):
            dname = name(dtype)
            a = randn(n, n, dtype=dtype)
            b = randn(n, n, dtype=dtype, scale=n ** -0.5)
            f64_product = lambda a=a, b=b: ref.matmul_ref(a.double(), b.double())
            self._case(
                "matmul", f"{dname} M={n} K={n} N={n}",
                lambda a=a, b=b: ops.matmul(a, b),
                lambda a=a, b=b: ref.fused_matmul_ref(a, b, dtype),
                lambda a=a, b=b: torch.matmul(a, b),
                dname,
                (n * 2.0 ** -24, 0.0) if dtype == f32 else tols[bf16],
                reference=f64_product if dtype == f32 else None, n_time=10)
            row = self.results["matmul"][-1]
            print(f"      tiled matmul {dname} {n}^2: kernel "
                  f"{2 * n ** 3 / row['ms'] / 1e9:.1f} TFLOP/s, torch.matmul "
                  f"{2 * n ** 3 / row['library_ms'] / 1e9:.1f} TFLOP/s")
            del a, b

        q = n // 4
        for m, k, nn, dtype, n_time in ((n, n, n, f32, 10), (n, n, n, bf16, 10),
                                        (q, q, q, f64, 50),
                                        (1000, 300, 700, f32, 50)):
            dname = name(dtype)
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
                dname, tol,
                reference=reference, n_time=n_time)
            del a, b

        library = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}
        for dtype in (f32, bf16, f64):
            dname = name(dtype)
            for rows, cols, names in ((n, n, ("add", "sub", "mul")),
                                      (1000, 1001, ("add",))):
                x, y = randn(rows, cols, dtype=dtype), randn(rows, cols, dtype=dtype)
                for op in names:
                    self._case(
                        "binary_op", f"{dname} {op} {rows}x{cols}",
                        lambda x=x, y=y, op=op: kew.binary_op(x, y, op),
                        lambda x=x, y=y, op=op: ref.binary_ref(x, y, op),
                        lambda x=x, y=y, op=op: library[op](x, y),
                        dname, exact, n_time=200 if rows == n else 50,
                        charge=an.binary_charge(x, y))
            x, y = randn(n, n, dtype=dtype), randn(n, n, dtype=dtype)
            alpha_t = torch.full((1,), 0.7, device=self.dev)
            for alpha, how in ((0.7, "a number"), (alpha_t, "an f32 tensor")):
                self._case(
                    "axpy", f"{dname} {n}x{n}, alpha {how}",
                    lambda alpha=alpha: kew.axpy(alpha, x, y),
                    lambda alpha=alpha: ref.saxpy_ref(alpha, x, y),
                    lambda: torch.add(y, x, alpha=0.7),
                    dname, exact, n_time=200,
                    charge=an.axpy_charge(alpha, x, y),
                    note="" if how == "a number" else
                    "; bound: + alpha's 4 bytes")
            del x, y
        # unaligned operands (one element into a buffer): the one-element path
        xu, yu = (randn(n * n + 1, dtype=f32)[1:].view(n, n) for _ in range(2))
        self._case("binary_op", f"float32 add {n}x{n} unaligned operands",
                   lambda: ops.add(xu, yu), lambda: ref.add_ref(xu, yu),
                   lambda: torch.add(xu, yu), "float32", exact)
        # complex64: add on the (re, im) pairs, through ops.add
        xc, yc = (torch.complex(randn(n // 2, n // 2, dtype=f32),
                                randn(n // 2, n // 2, dtype=f32))
                  for _ in range(2))
        self._case("binary_op", f"complex64 add {n // 2}x{n // 2} (f32 view)",
                   lambda: torch.view_as_real(ops.add(xc, yc)),
                   lambda: torch.view_as_real(ref.add_ref(xc, yc)),
                   lambda: torch.add(xc, yc), "float32", exact)
        del xu, yu, xc, yc

    # -- 4. the slice at full width --------------------------------------
    def phase_serve(self):
        torch = self.torch
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.kernels import ops
        from repro_torch.serving import ServingEngine, synthetic_trace
        cfg = get_config("qwen3-0.6b")
        t0 = time.perf_counter()
        params = self._serve_params(cfg)
        work = synthetic_trace(cfg, 8, rng=np.random.default_rng(0),
                               len_range=(64, 512), gen=32)
        # whole 16-token pages, the paged engine's rounding: phase 5's
        # paged engine on this trace then runs the same prefill shapes
        max_len = -(-max(len(it.prompt) + it.gen for it in work) // 16) * 16
        engine = ServingEngine(cfg, params, max_slots=4, max_len=max_len,
                               device=self.dev)
        del params                      # the engine keeps its bf16 copy
        torch.cuda.synchronize()
        print(f"[4/19] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} "
              f"heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.resolved_head_dim} "
              f"d_ff {cfg.d_ff} vocab {cfg.vocab}->{cfg.padded_vocab}; "
              f"weights ready in {time.perf_counter() - t0:.1f} s; "
              f"8 requests, prompts {[len(it.prompt) for it in work]}, gen 32, "
              f"4 slots, max_len {engine.max_len}")
        _print_capture(engine)
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
        self.serve_p50 = report["decode_step_p50_s"]
        self.serve_p99 = report["decode_step_p99_s"]

    def phase_trace(self):
        self._trace(self.engine, self.serve_p50,
                    expect=("matmul", "gated_matmul", "flash_decode"),
                    roofline=True)
        self._count_prefill(self.engine,
                            max((it.prompt for it in self.work), key=len))

    def _trace(self, eng, p50_s, n_steps=6, expect=(), prompt_len=256,
               roofline=False):
        """Decode steps of `eng` with 4 slots busy at a depth of
        `prompt_len` and on (an encdec request with random frames): first
        one replay against an eager step (`_check_replay`; with
        `roofline`, the eager step counted for phase 17), then a trace:
        the card's busy time a step, by kernel, beside the step's wall
        time on the host clock (the profiler's own host cost included, so
        the idle share read here is an upper bound) and the decode p50 of
        the phase's unprofiled run (`p50_s`). Each kernel group in
        `expect` must show in the trace; a step must be one graph launch
        and call no kernel wrapper."""
        torch = self.torch
        import numpy as np
        from torch.profiler import ProfilerActivity, profile
        rng = np.random.default_rng(2)
        cfg = eng.cfg
        for _ in range(4):
            frames = rng.normal(size=(cfg.enc_ctx, cfg.d_model)).astype(
                np.float32) if cfg.family == "encdec" else None
            eng.submit(rng.integers(0, cfg.vocab, prompt_len).astype(np.int32),
                       n_steps + 2, enc_frames=frames)
        eng.step()                      # admits all four, one decode step
        assert eng.scheduler.n_active == 4, eng.scheduler.n_active
        self._check_replay(eng, p50_s if roofline else None)
        first = len(eng._step_times)
        with _wrapper_calls() as calls, \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                eng.step()
            torch.cuda.synchronize()
        eng.run()
        assert not calls, f"a replayed step called kernel wrappers: {calls}"
        wall_ms = sum(eng._step_times[first:first + n_steps]) / n_steps * 1e3
        busy = _print_trace(prof, f"{n_steps} decode steps at 4 slots",
                            wall_ms, n_steps, expect)
        api, host_us = {}, {}
        for e in prof.events():
            if e.name.startswith(("cuda", "cu")) and "Launch" in e.name:
                api[e.name] = api.get(e.name, 0) + 1
                host_us[e.name] = (host_us.get(e.name, 0.0)
                                   + e.time_range.elapsed_us())
        graphs = sum(n for name, n in api.items() if "GraphLaunch" in name)
        calls = ", ".join(f"{name} {n / n_steps:g} a step "
                          f"({host_us[name] / n:.1f} us each on the host)"
                          for name, n in api.items())
        print(f"      replays: launch calls in the trace: {calls or 'none'}; "
              f"no kernel wrapper called; decode step p50 "
              f"{p50_s * 1e3:.2f} ms (the unprofiled run) against card "
              f"busy {'not measured' if busy is None else f'{busy:.3f} ms'}"
              f" a step")
        if api:
            assert graphs == n_steps, (graphs, n_steps, api)

    def _check_replay(self, eng, p50_s=None):
        """One replay of `eng`'s decode graph against an eager decode_step
        from a clone of the same state: logits and every cache leaf bit
        for bit. The state is put back after, so the streams go on as if
        the check had not run. Given `p50_s` (the phase's decode p50), the
        eager step is counted for phase 17 (`_count_step`): the replay's
        bits then show that counting changed none."""
        torch = self.torch
        from repro_torch.configs.base import ShapeCell
        from repro_torch.core.tree import leaves
        from repro_torch.models import model as M
        if eng.pool is not None:
            eng._prepare_pages(eng.scheduler.active)
        eng._step_tokens.copy_(eng._tokens_h)
        eng._step_pos.copy_(eng._pos_h)
        before = [t.clone() for t in leaves(eng.cache)]
        state = _clone_tree(eng.cache)
        got = eng._step().clone()

        def eager():
            return M.decode_step(eng.cfg, eng.params,
                                 eng._step_tokens.clone(),
                                 eng._step_pos.clone(), state)
        if p50_s is None:
            want, state = eager()
        else:
            n, depth = eng.scheduler.n_active, int(eng._pos_h.max()) + 1
            want, state = self._count_step(
                f"{eng.cfg.name} decode step, {n} slots at depth {depth}",
                eng.cfg, ShapeCell(f"decode_{n}x{depth}", "decode", depth, n),
                eager, p50_s * 1e3, "the phase's decode p50, graph replays")
        same = torch.equal(got, want) and all(
            torch.equal(a, b) for a, b in zip(leaves(eng.cache),
                                              leaves(state)))
        for t, old in zip(leaves(eng.cache), before):
            t.copy_(old)
        assert same, "a replayed decode step differs from the eager step"
        print(f"      replay: one decode step at {eng.scheduler.n_active} "
              f"busy slots equals an eager decode_step on a clone of the "
              f"engine's state, logits and {len(before)} cache leaves bit "
              f"for bit")

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
        from repro_torch.serving import ServingEngine, prefix_heavy_trace
        cfg = self.engine.cfg
        L = cfg.n_layers
        del self.engine                  # free phase 4's engine
        params = self._serve_params(cfg)

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
        print(f"[5/19] paged bf16 KV (page 16, {rep['kv_pool']['n_pages']} "
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
        _print_capture(eng)
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
        self._trace(eng, rep["decode_step_p50_s"],
                    expect=("matmul", "matmul_q", "flash_decode_paged"))

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

    # -- 6. the request surface at full width --------------------------
    def _serve_rows(self, eng, work, rows):
        """Serve `work` (all at t = 0) with the launch counts set to 0 just
        before; keep each request's target cache rows up to its last fed
        token in `rows[rid]`, taken as its slot is released (from the
        slot's cache row, or through its page table). Returns (requests,
        report, launches)."""
        torch = self.torch
        from repro_torch.kernels import ops
        release = eng._release

        def keep(req, slot, now, *more):
            n = req.prompt_len + req.n_generated - 1
            if eng.pool is None:
                rows[req.rid] = {k: v[:, slot, :n].clone()
                                 for k, v in eng.cache.items()}
            else:
                ps, pages = eng.page_size, eng.cache["pages"]
                phys = torch.as_tensor(eng.pool.table[slot], dtype=torch.long,
                                       device=self.dev)
                p = torch.arange(n, device=self.dev)
                rows[req.rid] = {k: pages[k][:, phys[p // ps], p % ps].clone()
                                 for k in ("k", "v")}
            release(req, slot, now, *more)
        eng._release = keep
        reqs = [eng.submit(it.prompt, it.gen) for it in work]
        ops.reset_launch_counts()
        report = eng.run()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        assert report["n_finished"] == len(reqs), report
        return reqs, report, launches

    def phase_spec(self):
        """(a) Greedy speculative decoding at full width: phase 4's 8
        requests on 4 slots, spec_k 4, the target as its own draft on the
        dense cache and a bf16 page pool, a draft of other weights (drawn
        on the card from seed 1) on the dense cache (its run on the pool
        is cut for time: the CPU tests hold its rows). Every stream must
        equal phase 4's, the self-draft must accept every proposal and the
        other draft must have some rejected, and each request's target
        cache rows up to its last fed token must equal the plain engine's
        bit for bit: a round that rejects proposals leaves its rows past
        the new pending position, where the next round overwrites them."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import model as M
        from repro_torch.serving import ServingEngine
        cfg = get_config("qwen3-0.6b")
        L = cfg.n_layers
        params = self._serve_params(cfg)
        other = M.init_params(
            cfg, torch.Generator(device=self.dev).manual_seed(1), self.dev)
        print(f"[6/19] the request surface at full width ({cfg.name}, "
              f"{L} layers, bf16, random weights)")
        want = {}
        eng = ServingEngine(cfg, params, max_slots=4, max_len=self.max_len,
                            device=self.dev)
        reqs, _, _ = self._serve_rows(eng, self.work, want)
        assert [r.generated for r in reqs] == self.dense_streams
        del eng
        self.spec_launches = {}
        for layout in ("dense", "paged"):
            for name, draft in (("self", params), ("seed-1", other)):
                if (layout, name) == ("paged", "seed-1"):
                    continue                 # cut for time (PERF.md)
                eng = ServingEngine(cfg, params, max_slots=4,
                                    max_len=self.max_len, device=self.dev,
                                    kv_layout=layout, draft=(cfg, draft),
                                    spec_k=4)
                got = {}
                reqs, rep, launches = self._serve_rows(eng, self.work, got)
                streams = [r.generated for r in reqs]
                assert streams == self.dense_streams, \
                    f"{layout} {name}-draft streams != phase 4's"
                rate = rep["spec_acceptance_rate"]
                assert rate == 1.0 if name == "self" else rate < 1.0, rate
                for rid, w in want.items():
                    for k in ("k", "v"):
                        assert torch.equal(got[rid][k], w[k]), \
                            f"{layout} {name}: request {rid} {k} rows differ"
                rows = "flash_decode_rows" if layout == "dense" \
                    else "flash_decode_paged_rows"
                rounds = rep["spec_rounds"]
                assert launches[rows] == L * rounds, (launches, rounds)
                for k in ("matmul", "gated_matmul", "flash_decode"):
                    assert launches[k] > 0, launches
                if name == "self":
                    self.spec_launches[rows] = launches[rows]
                print(f"      (a) spec {layout}, {name} draft, k=4: 8 streams "
                      f"= phase 4's token for token, target rows = the plain "
                      f"engine's bit for bit; {rounds} rounds, acceptance "
                      f"{rate:.3f} ({rep['spec_accepted']}/"
                      f"{rep['spec_proposed']}), tokens/slot-step "
                      f"{rep['tokens_per_step']:.2f}; {rows} "
                      f"{launches[rows] // rounds} a round; round p50 "
                      f"{rep['decode_step_p50_s'] * 1e3:.2f} ms p99 "
                      f"{rep['decode_step_p99_s'] * 1e3:.2f} (phase 4's "
                      f"decode step p50 {self.serve_p50 * 1e3:.2f}); draft "
                      f"{rep['draft_time_s'] * 1e3:.0f} ms of "
                      f"{sum(eng._step_times) * 1e3:.0f} ms of rounds; "
                      f"decode {rep['decode_tok_s']:.1f} slot-steps/s, "
                      f"ttft p50 {rep['ttft_p50_s'] * 1e3:.0f} ms, latency "
                      f"p50 {rep['latency_p50_s'] * 1e3:.0f} ms")
                if layout == "dense" and name == "self":
                    _print_capture(eng)
                    self_draft = rep
                del eng, got
        # the round's host copy: (4, 5, vocab) f32 logits rows
        x = torch.zeros((4, 5, cfg.padded_vocab), device=self.dev)
        times = []
        for _ in range(11):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x[:, :, :cfg.vocab].cpu()
            times.append(time.perf_counter() - t0)
        print(f"      a round's logits copy to the host ({4 * 5 * cfg.vocab * 4 / 1e6:.1f} MB): "
              f"median {statistics.median(times) * 1e3:.2f} ms of 11")
        del other, want
        self._int8_draft(cfg, params, self_draft)
        del params
        self._requests(cfg)
        self._chaos(cfg)

    def _int8_draft(self, cfg, params, bf16, k=4):
        """(d) The target's own weights as its draft with int8 weights
        (`draft_quant="int8"`: quantized once; the draft's decode and
        remainder graphs and its prefill on the int8-weight GEMM, its KV
        dense), phase 4's 8 requests on 4 slots at k = 4 on the dense
        cache: every stream phase 4's, exact launch counts (the draft's 7
        int8 GEMMs a layer in each of its k + 1 steps a round, each
        prefill and each remainder step; the target's GEMMs and multi-row
        decode attention), the acceptance and the round p50 beside the
        bf16 self-draft's (`bf16`, its report)."""
        from repro_torch.serving import ServingEngine
        L = cfg.n_layers
        eng = ServingEngine(cfg, params, max_slots=4, max_len=self.max_len,
                            device=self.dev, draft=(cfg, params), spec_k=k,
                            draft_quant="int8")
        reqs, rep, launches = self._run_counted(eng, self.work)
        assert [r.generated for r in reqs] == self.dense_streams, \
            "int8-draft streams != phase 4's"
        rounds, n = rep["spec_rounds"], len(reqs)
        rem = sum(len(r.prompt) % 8 for r in reqs)
        draft_runs = (k + 1) * rounds + n + rem
        target_runs = rounds + n + rem
        want = _no_launches(matmul_q=7 * L * draft_runs,
                            matmul=(5 * L + 1) * target_runs + draft_runs,
                            gated_matmul=L * target_runs,
                            flash_decode=L * (2 * rem + (k + 1) * rounds),
                            flash_decode_rows=L * rounds)
        assert launches == want, (launches, want)
        print(f"      (d) int8 draft (the target's weights quantized), k={k}, "
              f"dense cache: 8 streams = phase 4's token for token; "
              f"launches {_nonzero(launches)} (exact: matmul_q {7 * L} a "
              f"draft step, {k + 1} steps a round, {rounds} rounds, {n} "
              f"prefills, {rem} remainder tokens); acceptance "
              f"{rep['spec_acceptance_rate']:.3f} ({rep['spec_accepted']}/"
              f"{rep['spec_proposed']}; the bf16 self-draft's "
              f"{bf16['spec_acceptance_rate']:.3f}), round p50 "
              f"{rep['decode_step_p50_s'] * 1e3:.2f} ms p99 "
              f"{rep['decode_step_p99_s'] * 1e3:.2f} (bf16 draft "
              f"{bf16['decode_step_p50_s'] * 1e3:.2f} / "
              f"{bf16['decode_step_p99_s'] * 1e3:.2f}); draft "
              f"{rep['draft_time_s'] * 1e3:.0f} ms of "
              f"{sum(eng._step_times) * 1e3:.0f} ms of rounds (bf16 "
              f"{bf16['draft_time_s'] * 1e3:.0f} ms); tokens/slot-step "
              f"{rep['tokens_per_step']:.2f}")
        _print_capture(eng)

    def _chaos(self, cfg, nan=(6, 0), kernel=(3, 9), slow=(12, 0.25),
               deny=4):
        """(c) Serving under scripted faults at full width: phase 4's 8
        requests (4-7 at priority 1) on 4 slots over a bf16 page pool, one
        injector scripting a NaN logits row (slot 0 at step 6), a
        poisoned write page (slot 1, at the first step from 7 where its
        position is 2 or more rows into a page: the page's earlier rows
        NaN, so the fault comes out of flash_decode_paged's math; the
        kernel reads no key past pos), kernel faults at steps 3 and 9 (a
        retry, then the rebuild of the captured steps with 4 slots busy),
        a 0.25 s sleep at step 12 and a denied admission (ordinal 4: a
        preemption of a priority-0 request, and its resume). Gates: no
        crashed step, 2 kernel faults, degraded, step 12 flagged as a
        straggler; requests 0 and 1 alone quarantined, their tokens before
        the fault phase 4's; every other stream phase 4's; one preemption;
        every page back; the replay after the rebuild launches what one
        before it did, and no decode step after it calls a kernel
        wrapper; the graphs' pools and memory_allocated before and after
        the rebuild printed, the latter grown by no more than one graph
        pool; the rebuild's seconds; decode p50 and p99 beside phase
        4's."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.serving import FaultInjector, ServingEngine
        from repro_torch.serving.request import FINISHED, QUARANTINED
        from repro_torch.serving.steps import CapturedStep
        work = self.work
        p1 = len(work[1].prompt)
        cor = next(s for s in range(nan[0] + 1, nan[0] + 17)
                   if (p1 + s) % 16 >= 2)
        inj = FaultInjector(nan_rows={nan[0]: nan[1]}, corrupt_pages={cor: 1},
                            kernel_fail_steps=kernel,
                            slow_steps={slow[0]: slow[1]},
                            deny_admissions=(deny,))
        eng = ServingEngine(cfg, self._serve_params(cfg), max_slots=4,
                            max_len=self.max_len, device=self.dev,
                            kv_layout="paged", fault_injector=inj)
        before = dict(eng._step.launches)
        seen, watched = {}, []
        rebuild, run_step = eng._rebuild_steps, eng._run_step

        def measured(err):
            torch.cuda.synchronize()
            seen.update(active=eng.scheduler.n_active,
                        pools=eng.graph_pool_bytes,
                        before=torch.cuda.memory_allocated())
            rebuild(err)
            torch.cuda.synchronize()
            seen.update(after=torch.cuda.memory_allocated(),
                        pools_after=eng.graph_pool_bytes)

        def guarded(step_idx):
            if not eng.degraded:
                return run_step(step_idx)
            with _wrapper_calls() as calls:
                out = run_step(step_idx)
            watched.append(len(calls))
            return out
        eng._rebuild_steps, eng._run_step = measured, guarded
        reqs = [eng.submit(it.prompt, it.gen, priority=int(i >= 4))
                for i, it in enumerate(work)]
        ops.reset_launch_counts()
        rep = eng.run()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        # the fault-free formula: every admission's prefill (a resume's
        # too) and every one-token step runs the step's GEMMs; a faulted
        # attempt launches nothing, the rebuild's warm-ups are taken out
        L = cfg.n_layers
        rem = eng.prefill_tokens - sum(
            (len(r.prompt) - len(r.prompt) % 8 or len(r.prompt))
            * (1 + r.preemptions) for r in reqs)
        runs = eng.decode_steps + rem + eng._admissions
        want = _no_launches(matmul=(5 * L + 1) * runs, gated_matmul=L * runs,
                            flash_decode=L * rem,
                            flash_decode_paged=L * eng.decode_steps)
        assert launches == want, (launches, want)
        assert rep["crashed_steps"] == 0 and rep["kernel_faults"] == 2, rep
        assert rep["degraded"] and rep["straggler_steps"] >= 1, rep
        assert any(s == slow[0] for s, _, _ in eng.straggler.flagged), \
            eng.straggler.flagged
        assert rep["faults_injected"] == {
            "nan_rows": 1, "page_corruptions": 1, "kernel_faults": 2,
            "slow_steps": 1, "denied_admissions": 1}, rep["faults_injected"]
        assert [r.status for r in reqs] == [QUARANTINED] * 2 + \
            [FINISHED] * 6, [r.status for r in reqs]
        assert reqs[0].error == f"non-finite logits at decode step {nan[0]}"
        assert reqs[1].error == f"non-finite logits at decode step {cor}"
        for r, want in zip(reqs, self.dense_streams):
            assert r.generated == want[:len(r.generated)], r.rid
        assert rep["preempted"] == 1 and rep["quarantined"] == 2, rep
        pool = eng.pool
        assert (pool.refcount == 0).all() and pool.n_reserved == 0
        assert isinstance(eng._step, CapturedStep)
        assert eng._step.launches == before, (eng._step.launches, before)
        assert watched and not any(watched), watched
        biggest = max(eng._step.pool_bytes, eng._remainder_step.pool_bytes)
        assert seen["active"] == 4, seen
        assert seen["after"] - seen["before"] <= biggest, seen
        victim = next(r for r in reqs if r.preemptions)
        # the wrappers close over the engine: drop them, so that no
        # reference cycle keeps it alive after the phase
        del eng._rebuild_steps, eng._run_step
        print(f"      (c) chaos, bf16 pool: NaN row slot {nan[1]} at step "
              f"{nan[0]}, poisoned page slot 1 at step {cor} (position "
              f"{p1 + cor}), kernel faults at steps {kernel}, a "
              f"{slow[1]} s sleep at step {slow[0]}, admission {deny} "
              f"denied: {rep['n_finished']} finished = phase 4's streams, "
              f"requests 0 and 1 quarantined (their {len(reqs[0].generated)}"
              f" and {len(reqs[1].generated)} tokens phase 4's), request "
              f"{victim.rid} preempted and resumed; every page back; "
              f"kernel_faults {rep['kernel_faults']}, crashed_steps "
              f"{rep['crashed_steps']}, straggler steps "
              f"{[s for s, _, _ in eng.straggler.flagged]}; "
              f"faults_injected {json.dumps(rep['faults_injected'])}; "
              f"launches {_nonzero(launches)} (the fault-free formula's: "
              f"{eng._admissions} admissions, {rem} remainder tokens, "
              f"{eng.decode_steps} decode steps)")
        print(f"      (c) the rebuild at step {kernel[1]} with "
              f"{seen['active']} slots busy: {eng.rebuild_s:.3f} s; graph "
              f"pools {seen['pools'] / 2 ** 20:.2f} -> "
              f"{seen['pools_after'] / 2 ** 20:.2f} MiB; memory_allocated "
              f"{seen['before'] / 2 ** 30:.4f} -> {seen['after'] / 2 ** 30:.4f}"
              f" GiB ({seen['after'] - seen['before']:+d} B, a graph pool "
              f"{biggest} B); a replay launches {_nonzero(eng._step.launches)}"
              f" before and after; {len(watched)} decode steps after it, no "
              f"kernel wrapper called")
        print(f"      (c) decode step p50 {rep['decode_step_p50_s'] * 1e3:.2f}"
              f" ms p99 {rep['decode_step_p99_s'] * 1e3:.2f} ms (phase 4's "
              f"{self.serve_p50 * 1e3:.2f} / {self.serve_p99 * 1e3:.2f}; the "
              f"p99 holds the sleep and the rebuild), {rep['decode_steps']} "
              f"steps, goodput {rep['goodput']:.3f}, ttft p50 "
              f"{rep['ttft_p50_s'] * 1e3:.0f} ms")
        del eng

    def _requests(self, cfg):
        """(b) One paged run (a bf16 pool small enough to force
        preemption) of a bursty trace with priority levels (0, 1), on a
        clock that advances one unit a step: a waiter with a deadline that
        expires, one waiting and one active request cancelled, an eos
        token (phase 4's request 5 is in the trace, its stream cut there).
        Greedy, every finished stream (the preempted ones, and those
        admitted after the cancels) equals its request served alone, and
        every page is back in the pool at the end. With a temperature
        sampler over the top 50, the same run twice gives the same
        streams, every token in its row's top 50. Then the trace on the
        wall clock, sampled."""
        torch = self.torch
        import numpy as np
        from repro_torch.serving import (Sampler, SamplerConfig, ServingEngine,
                                         bursty_trace)
        params = self._serve_params(cfg)
        work = bursty_trace(cfg, 12, rng=np.random.default_rng(5),
                            len_range=(64, 256), gen=24, arrival_rate=0.25,
                            burst_mean=4.0, priority_levels=(0, 1))
        first, stream = self.work[5], self.dense_streams[5]
        eos = stream[4]
        cut = stream.index(eos) + 1
        kw = dict(max_slots=4, max_len=320, device=self.dev,
                  kv_layout="paged", page_size=16, kv_pool_pages=48,
                  eos_id=eos, preempt_backoff=2.0)

        class TopK(Sampler):
            """Temperature over the top 50; each token checked in its row's
            top 50."""
            def __call__(self, logits):
                tok = super().__call__(logits)
                kth = np.partition(logits, -50)[-50]
                assert logits[tok] >= kth, "a sampled token outside the top 50"
                return tok

        def run(sampler, step_clock=True):
            eng = ServingEngine(cfg, params, sampler=sampler, **kw)
            reqs = [eng.submit(first.prompt, 32, priority=1)]
            reqs += [eng.submit(it.prompt, it.gen, arrival_time=it.arrival,
                                priority=it.priority) for it in work]
            if not step_clock:
                return eng, reqs, eng.run(), {}
            now = [0.0]
            eng._now = lambda: now[0]
            marks = {}
            for i in range(3000):
                sch = eng.scheduler
                if i == 2:
                    # it arrives between two steps and its deadline passes
                    # before the next: the next step drops it unadmitted
                    marks["deadline"] = eng.submit(
                        work[0].prompt, 8, arrival_time=now[0] + 0.5,
                        deadline=now[0] + 0.75)
                if "cancel" not in marks and i >= 8 and sch.n_waiting \
                        and sch.n_active:
                    waiting = min(sch._waiting, key=lambda r: r.rid)
                    active = max(sch.active.values(), key=lambda r: r.rid)
                    assert eng.cancel(waiting.rid) and eng.cancel(active.rid)
                    marks["cancel"] = (now[0], waiting, active)
                more = eng.step()
                now[0] += 1.0
                if not more:
                    break
            else:
                raise AssertionError("the step-clock run did not drain")
            torch.cuda.synchronize()
            return eng, reqs + [marks["deadline"]], eng.report(), marks

        eng, reqs, rep, marks = run(Sampler())
        pool = eng.pool.report()
        assert (eng.pool.refcount == 0).all() and eng.pool.n_reserved == 0
        assert pool["pages_free"] == pool["n_pages"], pool
        assert rep["preempted"] >= 1 and rep["cancelled"] == 2, rep
        assert marks["deadline"].status == "expired", marks["deadline"].status
        t_cancel = marks["cancel"][0]
        assert reqs[0].generated == stream[:cut], \
            "the eos request's stream is not phase 4's cut at eos"
        checked = after = preempted = 0
        for r in reqs:
            if r.status != "finished":
                continue
            want = self._alone(eng, r.prompt, r.max_new_tokens)
            if eos in want:
                want = want[:want.index(eos) + 1]
            assert r.generated == want, f"request {r.rid} != served alone"
            checked += 1
            after += r.t_admitted is not None and r.t_admitted > t_cancel
            preempted += r.preemptions > 0
        assert after >= 1 and preempted >= 1, (after, preempted)
        print(f"      (b) requests, step clock, greedy: {len(reqs)} requests "
              f"(bursty, priorities 0/1, a 24-token gen; phase 4's request 5 "
              f"with eos {eos}, cut after {cut} tokens), pool "
              f"{pool['n_pages']} pages of 16: {rep['n_finished']} finished, "
              f"{rep['preempted']} preemptions ({preempted} requests), "
              f"{rep['cancelled']} cancelled, {rep['expired']} expired; "
              f"{checked} finished streams = each served alone ({preempted} "
              f"preempted, {after} admitted after the cancels); every page "
              f"back in the pool; decode steps {rep['decode_steps']}")
        del eng
        runs = []
        for _ in range(2):
            e, rs, rp, _ = run(TopK(SamplerConfig("temperature", 1.0, 50),
                                    seed=0))
            assert (e.pool.refcount == 0).all() and e.pool.n_reserved == 0
            runs.append([(r.status, r.generated) for r in rs])
            del e
        assert runs[0] == runs[1], "one seed gave two sampled runs"
        print(f"      (b) temperature 1.0, top-k 50, seed 0, step clock: two "
              f"runs gave the same {len(runs[0])} streams; every sampled "
              f"token in its row's top 50; {rp['n_finished']} finished, "
              f"{rp['preempted']} preemptions, every page back")
        kw.pop("eos_id")
        work = bursty_trace(cfg, 12, rng=np.random.default_rng(5),
                            len_range=(64, 256), gen=24, arrival_rate=8.0,
                            burst_mean=4.0, deadline=1.5,
                            priority_levels=(0, 1))
        eng = ServingEngine(cfg, params, sampler=TopK(
            SamplerConfig("temperature", 1.0, 50), seed=0), **kw)
        reqs = [eng.submit(it.prompt, it.gen, arrival_time=it.arrival,
                           deadline=it.deadline, priority=it.priority)
                for it in work]
        rep = eng.run()
        torch.cuda.synchronize()
        print(f"      (b) wall clock: 12 bursty requests at 8 req/s (groups "
              f"of 1 + Poisson(3)), deadline 1.5 s after arrival, priorities "
              f"0/1, temperature top-k 50: decode {rep['decode_tok_s']:.1f} "
              f"tok/s (occupancy {rep['mean_occupancy']:.2f}/4), decode step "
              f"p50 {rep['decode_step_p50_s'] * 1e3:.2f} ms, ttft p50 "
              f"{rep['ttft_p50_s'] * 1e3:.0f} ms p95 "
              f"{rep['ttft_p95_s'] * 1e3:.0f} ms, deadline miss rate "
              f"{rep['deadline_miss_rate']:.3f}, {rep['n_finished']} "
              f"finished, {rep['expired']} expired, {rep['preempted']} "
              f"preemptions, goodput {rep['goodput']:.3f}")
        del eng, params

    # -- 7. training at full width -----------------------------------
    def phase_train(self, steps=8, batch=4, seq=512):
        """8 AdamW steps of qwen3-0.6b at full width and depth: f32
        params, bf16 activations, random weights from seed 0, SyntheticLM
        batches from seed 0, lr 1e-3 with 2 warmup steps, clip 1.0, each
        block rematerialised (the config's remat "full"). The loss must
        end below where it began. It does not within 4 steps: Adam's first
        steps, near sign(g) times lr for every weight, lift it (12.29 to
        16.79 by step 3, through the kernels and through the plain versions
        alike), and it falls from step 4 on. The steps are donated and
        supervised, as `launch.train --ckpt-dir D --ckpt-every 4 --fail-at
        6` runs them: a checkpoint at step 4, a failure before step 6, and
        steps 4 and 5 again from the restored state, with their first
        run's bits (`_supervised`). Then the first 4 steps with remat
        "none" from the same state and batches and the first 2 through the
        plain versions (the 4 with only the dual GEMM plain are cut for
        time: their finding stands in PERF.md)."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.configs.base import ShapeCell
        from repro_torch.core.tree import tree_map
        from repro_torch.models import model as M
        from repro_torch.optim.adamw import AdamW, cosine_schedule
        from repro_torch.training import train_loop as TL
        cfg = get_config("qwen3-0.6b")
        L = cfg.n_layers
        torch.cuda.empty_cache()
        opt = AdamW(lr=cosine_schedule(1e-3, 2, steps), clip_norm=1.0)

        # drawn once on the host's generator (TL.init_state's params), a
        # copy a state (phase 16's tuned step takes one too)
        host = tree_map(lambda t: t.to("cpu", copy=True), M.init_params(
            cfg, torch.Generator().manual_seed(0), self.dev))

        def make_state():
            params = tree_map(lambda t: t.to(self.dev, copy=True), host)
            return TL.TrainState(params, opt.init(params))
        batches = self._train_batches(cfg, steps + 1, batch, seq)
        print(f"[7/19] training {cfg.name} at full width ({L} layers, bf16 "
              f"activations, remat {cfg.remat}): {steps} AdamW steps at batch "
              f"{batch} x {seq}")
        # a step: the forward's 141 GEMMs, 28 dual GEMMs and 28 attentions;
        # remat runs each block's forward again before its backward (140
        # GEMMs: the logits GEMM is outside the blocks; 28 dual GEMMs, 28
        # attentions); the backward's 2 GEMMs for each of the 141 (dx, dw)
        # plus 4 for each dual GEMM (its gate/up recompute and their dw;
        # dx of the two branches is 2 more), and 28 attention backwards
        want = _no_launches(matmul=(5 * L + 1) * 3 + 6 * L + 5 * L,
                            gated_matmul=2 * L, flash_attention=2 * L,
                            flash_attention_bwd=L)
        run = self._train_run(TL.make_train_step(cfg, opt, donate=True),
                              make_state, batches[:steps], want,
                              supervise=dict(every=4, fail_at=(6,)))
        self.train_launches = run["launches"]
        self.train_step0 = dict(host=host, opt=opt, batch=batches[0],
                                want=want, loss=run["losses"][0],
                                norm=run["norms"][0])
        cell = ShapeCell(f"train_{batch}x{seq}", "train", seq, batch)
        state = run.pop("state")
        state, _ = self._count_step(
            f"{cfg.name} train step, remat {cfg.remat}", cfg, cell,
            lambda: run["step_fn"](state, batches[steps]),
            run["steady"] * 1e3, "the steady step, host clock")
        self._trace_train_step(run["step_fn"], state, batches[steps])
        del state
        self._remat_none(cfg, opt, make_state, batches[:4], run,
                         donate=False, roofline=cell)
        self._train_plain(cfg, opt, make_state, batches, run, 2)

    def _train_batches(self, cfg, n, batch, seq, seed=0, device=None):
        """n SyntheticLM batches of seed `seed` on `device` (the card), with
        what the family's forward reads: an encdec batch's (B, enc_ctx,
        d_model) f32 frames, a vlm row's 16 x 16 image span at position 32
        (`data.pipeline.with_image`: patch embeddings, (t, h, w) positions,
        labels -1 at the patches), both drawn from
        np.random.default_rng([seed, i]) for batch i."""
        import numpy as np
        from repro_torch.data.pipeline import SyntheticLM, with_image
        torch = self.torch
        data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch,
                           seed=seed)
        out = []
        for i in range(n):
            b, rng = data.batch_at(i), np.random.default_rng([seed, i])
            if cfg.family == "encdec":
                b["enc_frames"] = rng.standard_normal(
                    (batch, cfg.enc_ctx, cfg.d_model), dtype=np.float32)
            elif cfg.family == "vlm":
                b = with_image(b, rng, cfg.d_model, at=32)
            out.append({k: torch.as_tensor(
                v, dtype=torch.long if v.dtype.kind == "i" else None,
                device=device or self.dev) for k, v in b.items()})
        return out

    def _train_run(self, step_fn, make_state, batches, want, falls=None,
                   supervise=None):
        """The steps of `step_fn` from `make_state()`, one a batch, the
        launch counts set to 0 just before and read after each step: each
        step's counts must be `want`, every loss and grad norm finite, the
        last loss below the first (or, given `falls`, `falls(losses)`
        true: `loss_falls`). Prints the state's size, each step and
        the steady step time (the median after step 0), tok/s and
        max_memory_allocated. With `supervise` ({"every": n, "fail_at":
        (s,)}) the steps run under `distributed.Supervisor` with a
        Checkpointer (`_supervised`): a save every n steps, a failure
        injected before step s, the latest save restored into the state's
        tensors and the steps from it run again, each replay held to its
        first run's bits; the losses, norms and times are the first run's
        of each step. Returns the state, step_fn, losses, norms, steady
        seconds, peak bytes and the run's launch counts."""
        torch = self.torch
        import gc
        from repro_torch.core.tree import leaves
        from repro_torch.kernels import ops
        tokens = batches[0]["tokens"].numel()
        gc.collect()                      # earlier phases' cycles
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state = make_state()
        n_params = sum(x.numel() for x in leaves(state.params))
        print(f"      {n_params / 1e9:.3f} G f32 params; the "
              f"params and AdamW moments "
              f"{(torch.cuda.memory_allocated() - held) / 2 ** 30:.3f} GiB on "
              f"the card, made in {time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        runs = []                         # one record a step run

        def one(state, i):
            before = ops.launch_counts()
            t0 = time.perf_counter()
            state, met = step_fn(state, batches[i])
            loss, norm = float(met["loss"]), float(met["grad_norm"])
            aux = "".join(f" {k} {float(met[k]):.4g}" for k in (
                "moe_lb_loss", "moe_z_loss", "moe_dropped_frac") if k in met)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            now = ops.launch_counts()
            runs.append(dict(step=i, loss=loss, norm=norm, aux=aux, t=t,
                             launches={k: now[k] - before[k] for k in now}))
            return state, met

        if supervise is None:
            for i in range(len(batches)):
                state, _ = one(state, i)
        else:
            state = self._supervised(state, one, len(batches), runs,
                                     **supervise)
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        first = {}
        for r in runs:
            again = r["step"] in first
            print(f"      step {r['step']}{' (replay)' if again else ''}: "
                  f"loss {r['loss']:.4f} grad norm {r['norm']:.4f}{r['aux']} "
                  f"wall {r['t'] * 1e3:.1f} ms ({tokens / r['t']:.0f} tok/s)")
            assert r["launches"] == want, (r["step"], r["launches"], want)
            if again:
                assert (r["loss"], r["norm"]) == (first[r["step"]]["loss"],
                                                  first[r["step"]]["norm"]), \
                    f"replayed step {r['step']}: not its first run's bits"
            else:
                first[r["step"]] = r
        assert sorted(first) == list(range(len(batches))), sorted(first)
        losses = [first[i]["loss"] for i in range(len(batches))]
        norms = [first[i]["norm"] for i in range(len(batches))]
        times = [first[i]["t"] for i in range(len(batches))]
        assert all(map(math.isfinite, losses + norms)), (losses, norms)
        if falls is None:
            assert losses[-1] < losses[0], losses
        else:
            lead, trail, ok = falls(losses)
            print(f"      falling-loss gate: the mean of the last "
                  f"{len(losses) // 4} losses {trail:.4f} below the mean of "
                  f"the first {len(losses) // 4} {lead:.4f}: "
                  f"{'holds' if ok else 'FAILS'}")
            assert ok, losses
        steady = statistics.median(times[1:])
        print(f"      launches a step {_nonzero(want)} (each step run "
              f"exactly); over the run ({len(runs)} step runs) "
              f"{_nonzero(launches)}; steady step "
              f"{steady * 1e3:.1f} ms, {tokens / steady:.0f} tok/s; "
              f"max_memory_allocated {peak / 2 ** 30:.3f} GiB ("
              f"{held / 2 ** 30:.3f} GiB of it held before the state was "
              f"made)")
        return dict(state=state, step_fn=step_fn, losses=losses, norms=norms,
                    steady=steady, peak=peak, launches=launches)

    def _supervised(self, state, one, n_steps, runs, every, fail_at):
        """`one(state, i)` for steps 0 .. n_steps - 1 under a Supervisor
        with a Checkpointer (keep=1) in a temporary directory under
        build/, removed at the end: a save without blocking every `every`
        steps, a failure injected before each step of `fail_at`, then
        the latest save restored into the state's own tensors (the same
        storage before and after) and the steps from it run again. The
        state after each step before a failure is copied to pinned host
        memory (off the step's clock) and its replay must give it bit for
        bit.
        Prints the free disk before the run and each save's bytes and
        seconds (the host copy before save returns, the files on the
        writer thread) and each restore's."""
        torch = self.torch
        import shutil
        import tempfile
        from repro_torch.checkpoint import Checkpointer, flatten
        from repro_torch.distributed import FailureInjector, Supervisor

        class Timed(Checkpointer):
            def save(ck, step, tree, **kw):
                t0 = time.perf_counter()
                super().save(step, tree, **kw)
                ck.log.append(f"save of step {step}: host copy "
                              f"{time.perf_counter() - t0:.2f} s")

            def _write(ck, step, host, manifest):
                t0 = time.perf_counter()
                super()._write(step, host, manifest)
                n = sum(a.nbytes for a in host)
                ck.log.append(f"files of step {step}: {n / 1e9:.3f} GB in "
                              f"{time.perf_counter() - t0:.2f} s")

            def restore(ck, step, like):
                t0 = time.perf_counter()
                out = super().restore(step, like)
                torch.cuda.synchronize()
                ck.log.append(f"restore of step {step} into the state: "
                              f"{time.perf_counter() - t0:.2f} s")
                return out

        base = ROOT / "build"
        base.mkdir(exist_ok=True)
        print(f"      supervised: a save every {every} steps (keep 1), a "
              f"failure before step(s) {list(fail_at)}; "
              f"{shutil.disk_usage(base).free / 1e9:.1f} GB free under "
              f"{base}")
        ptrs = [t.data_ptr() for t in flatten(state)]
        again = {s - 1 for s in fail_at}          # the steps to hold
        snaps, live = {}, {}

        def step_fn(state, i):
            live["state"] = state
            return one(state, i)

        def on_metrics(step, metrics, dt):
            leaves = flatten(live["state"])
            if step in again and step not in snaps:
                # pinned host copies: the card holds no second state
                snaps[step] = [torch.empty(t.shape, dtype=t.dtype,
                                           pin_memory=t.is_cuda).copy_(t)
                               for t in leaves]
            elif step in snaps:
                for j, (a, b) in enumerate(zip(snaps[step], leaves)):
                    assert torch.equal(a.to(b.device), b), \
                        f"the state after the replay of step {step}, " \
                        f"leaf {j}: not its first run's bits"
                print(f"      the state after the replay of step {step} "
                      f"equals its first run's, {len(leaves)} leaves bit "
                      f"for bit")

        with tempfile.TemporaryDirectory(prefix="ckpt-", dir=base) as d:
            ck = Timed(d, keep=1)
            ck.log = []
            sup = Supervisor(ck, checkpoint_every=every)
            state, reached = sup.run_resilient(
                state, step_fn, n_steps,
                injector=FailureInjector(tuple(fail_at)),
                on_metrics=on_metrics)
            kept = ck.steps()
        for line in ck.log:
            print(f"      {line}")
        order = [r["step"] for r in runs]
        print(f"      step runs {order}; restarts {sup.restarts}; "
              f"stragglers {len(sup.straggler.flagged)}; checkpoints left "
              f"{kept}")
        assert reached == n_steps and sup.restarts == len(fail_at), \
            (reached, sup.restarts)
        assert snaps.keys() == again, (sorted(snaps), again)
        assert [t.data_ptr() for t in flatten(state)] == ptrs, \
            "the restore did not write into the state's own tensors"
        return state

    def _remat_none(self, cfg, opt, make_state, batches, run, donate,
                    rtol=1e-5, roofline=None):
        """The run's steps again with remat "none", from the state and on
        the batches the run (`_train_run`'s, remat "full") took: step 0's
        loss must be the run's bit for bit (the forward launches the same
        kernels on the same inputs; remat changes only what the backward
        keeps), its grad norm within rtol 1e-5 (the embedding's
        scatter-add is unordered on the card). Prints both peaks and both
        steady step times, each the median after step 0 of as many steps
        in this call. The caller has dropped the run's state. Given
        `roofline` (a ShapeCell), one more step on batch 0 is counted for
        phase 17 (`_count_step`; not donated, and its state dropped)."""
        torch = self.torch
        import dataclasses
        import gc
        from repro_torch.training import train_loop as TL
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        state = make_state()
        step_fn = TL.make_train_step(dataclasses.replace(cfg, remat="none"),
                                     opt, donate=donate)
        out, times = [], []
        for b in batches:
            t0 = time.perf_counter()
            state, met = step_fn(state, b)
            out.append((float(met["loss"]), float(met["grad_norm"])))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        (loss, gn), steady = out[0], statistics.median(times[1:])
        if roofline is not None:
            self._count_step(
                f"{cfg.name} train step, remat none",
                dataclasses.replace(cfg, remat="none"), roofline,
                lambda: step_fn(state, batches[0]), steady * 1e3,
                "the steady step, host clock")
        del state
        torch.cuda.empty_cache()
        print(f"      remat none, from the same state and batches: step 0 "
              f"loss {loss:.6f} grad norm {gn:.6f} (remat full "
              f"{run['losses'][0]:.6f} / {run['norms'][0]:.6f}); steady "
              f"step {steady * 1e3:.1f} ms against full's "
              f"{run['steady'] * 1e3:.1f} (median of steps 1-"
              f"{len(times) - 1} each; full/none "
              f"{run['steady'] / steady:.3f}); max_memory_allocated "
              f"{peak / 2 ** 30:.3f} GiB ({held / 2 ** 30:.3f} GiB of it held "
              f"before the state was made; full {run['peak'] / 2 ** 30:.3f})")
        assert loss == run["losses"][0], (loss, run["losses"][0])
        assert abs(gn - run["norms"][0]) <= rtol * run["norms"][0], \
            (gn, run["norms"][0])
        return dict(peak=peak, steady=steady)

    def _train_plain(self, cfg, opt, make_state, batches, run, steps,
                     donate=False, rtol=1e-3):
        """The run's first `steps` steps again from its weights
        (`make_state`), with the kernel dispatchers sent to the plain
        PyTorch versions on the card: step 0's loss and grad norm (no
        update yet) agree with the kernels' within rtol 1e-3 (bf16
        activations rounded at other places); later steps are printed
        beside the kernels' (Adam's sign-like first steps amplify those
        differences, and the plain run shows the kernels' jumps of the
        loss where they come from the optimizer)."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.training import train_loop as TL
        losses, norms = run["losses"], run["norms"]
        on_card = ops._on_card
        ops._on_card = lambda t: False
        try:
            state = make_state()
            step_fn = TL.make_train_step(cfg, opt, donate=donate)
            plain = []
            for i in range(steps):
                t0 = time.perf_counter()
                state, met = step_fn(state, batches[i])
                plain.append((float(met["loss"]), float(met["grad_norm"]),
                              time.perf_counter() - t0))
        finally:
            ops._on_card = on_card
        del state
        torch.cuda.empty_cache()
        for i, (loss, gn, t) in enumerate(plain):
            print(f"      plain versions, step {i}: loss {loss:.4f} grad norm "
                  f"{gn:.4f} (kernels {losses[i]:.4f} / {norms[i]:.4f}); "
                  f"wall {t * 1e3:.0f} ms")
        assert abs(plain[0][0] - losses[0]) <= rtol * abs(losses[0]), plain
        assert abs(plain[0][1] - norms[0]) <= rtol * abs(norms[0]), plain

    def _trace_train_step(self, step_fn, state, batch,
                          expect=("matmul", "gated_matmul", "flash_attention",
                                  "flash_attention_bwd")):
        """One more step under torch.profiler: the card's busy time, by
        kernel group (the SSD Function's backward, the plain chunked scan
        differentiated by autograd, and the AdamW update each a group of
        their own), against the step's wall time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile, record_function
        from repro_torch.optim.adamw import AdamW
        update = AdamW.update

        def named_update(opt, *args, **kw):
            with record_function("AdamW.update"):
                return update(opt, *args, **kw)
        torch.cuda.synchronize()
        AdamW.update = named_update
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step_fn(state, batch)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            AdamW.update = update
        _print_trace(prof, "a train step", wall_ms,
                     expect=expect + ("adamw update",),
                     own={"_SSDBackward": "ssd backward (plain)",
                          "AdamW.update": "adamw update"})

    def phase_train_vs_cpu(self, batch=1, seq=256, tol=1e-4):
        """A whole train step of qwen3-0.6b at full width, depth 2, f32
        activations, on the card and on the CPU (`_train_step_vs_cpu`)."""
        import dataclasses
        from repro_torch.configs import get_config
        cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                                  dtype="float32")
        self._train_step_vs_cpu(cfg, batch, seq, tol, "depth 2")

    def _train_step_vs_cpu(self, cfg, batch, seq, tol, what):
        """One donated AdamW step on the card (the CUDA kernels) and on the
        CPU (their plain versions) from the same weights (seed 0; a
        hybrid's lora_b from seed 1) and batch (`_train_batches`' first):
        the loss and the global grad norm agree within rtol `tol` (f32 sums
        in another order)."""
        torch = self.torch
        from repro_torch.core.tree import tree_map
        from repro_torch.optim.adamw import AdamW
        from repro_torch.training import train_loop as TL
        opt = AdamW(lr=1e-3, clip_norm=1.0)
        params = self._train_params(cfg, "cpu")
        out = []
        for dev in (self.dev, torch.device("cpu")):
            p = tree_map(lambda x: x.to(dev, copy=True), params)
            state = TL.TrainState(p, opt.init(p))
            b, = self._train_batches(cfg, 1, batch, seq, device=dev)
            t0 = time.perf_counter()
            state, met = TL.make_train_step(cfg, opt, donate=True)(state, b)
            out.append((float(met["loss"]), float(met["grad_norm"]),
                        time.perf_counter() - t0))
            del state, p
        (loss, gn, tc), (loss_c, gn_c, tp) = out
        assert abs(loss - loss_c) <= tol * abs(loss_c), (loss, loss_c)
        assert abs(gn - gn_c) <= tol * abs(gn_c), (gn, gn_c)
        print(f"      {cfg.name} {what}, f32, batch {batch} x {seq}, one step: "
              f"card loss {loss:.6f} grad norm {gn:.6f} ({tc * 1e3:.0f} ms); "
              f"CPU loss {loss_c:.6f} grad norm {gn_c:.6f} ({tp * 1e3:.0f} "
              f"ms); rel diff {abs(loss - loss_c) / loss_c:.2e} / "
              f"{abs(gn - gn_c) / gn_c:.2e} (rtol {tol:g})")

    def _seed_params(self, cfg):
        """A fresh copy on the card of cfg's random params, drawn on the
        card (`_train_params` with the card's generator of seed 0) at the
        first call for cfg's name and kept on the host for the next: the
        host's generator took 41 s for mamba2-2.7b's 2.8 G params on an
        H100 machine's CPU, the card's takes ~1 s, a copy ~2 s."""
        from repro_torch.core.tree import tree_map
        if cfg.name not in self.host_params:
            self.host_params[cfg.name] = tree_map(
                lambda t: t.to("cpu", copy=True),
                self._train_params(cfg, self.dev, self.dev))
        return tree_map(lambda t: t.to(self.dev, copy=True),
                        self.host_params[cfg.name])

    def _serve_params(self, cfg):
        """A copy on the card of cfg's random params from the host's
        generator of seed 0, drawn at the first call and kept on the host
        for the next: phases 4, 5 and 6 serve qwen3-0.6b's, which each
        drew anew on the host before."""
        from repro_torch.core.tree import tree_map
        from repro_torch.models import model as M
        key = f"{cfg.name} served"
        if key not in self.host_params:
            self.host_params[key] = M.init_params(
                cfg, self.torch.Generator().manual_seed(0), "cpu")
        return tree_map(lambda t: t.to(self.dev, copy=True),
                        self.host_params[key])

    def _train_params(self, cfg, device, gen_device="cpu"):
        """Random params from seed 0 on `gen_device`'s generator (a
        hybrid's lora_b from seed 1)."""
        from repro_torch.models import model as M
        if cfg.family == "hybrid":
            return self._hybrid_params(cfg, device, gen_device)
        return M.init_params(
            cfg, self.torch.Generator(device=gen_device).manual_seed(0),
            device)

    # -- 8. training the Mamba-2 families at full width -----------------
    def phase_train_recurrent(self, steps=16, batch=4, seq=512):
        """zamba2-1.2b at full width and depth and mamba2-2.7b at full
        width (`_train_recurrent`, 16 steps each, held to `loss_falls`;
        zamba2's first 2 without remat, and the first step of each through
        the plain versions; weights drawn on the card, `_seed_params`).
        Their whole f32 steps at depth 2 on
        the card against the CPU are tests/test_torch_cuda.py's
        `test_recurrent_train_step_on_card_matches_cpu` (cut here for
        time)."""
        from repro_torch.configs import get_config
        print("[8/19] training the Mamba-2 families at full width")
        self.zamba_train_launches = self._train_recurrent(
            get_config("zamba2-1.2b"), steps, batch, seq, plain_steps=1)
        self.mamba_train_launches = self._train_recurrent(
            get_config("mamba2-2.7b"), steps, batch, seq, plain_steps=1,
            remat_none=False, roofline=True)

    def _train_recurrent(self, cfg, steps, batch, seq, plain_steps,
                         remat_none=True, roofline=False):
        """`steps` donated AdamW steps at full width (f32 params, bf16
        activations, random weights from seed 0 on the card's generator
        and a hybrid's lora_b from seed 1, SyntheticLM batches from seed 0, lr 1e-3 with 2 warmup
        steps and a cosine over `steps`, clip 1.0), each Mamba-2 layer
        rematerialised (remat "full"): exact launch counts a step, finite
        losses that fall by `loss_falls`, speed, memory, the state's
        bytes, a trace of a step with the plain SSD backward as a group of
        its own; then (`remat_none`) the first 2 steps again with remat
        "none" from the same state and batches, and the first
        `plain_steps` through the plain versions on the card (step 0 held
        to the kernels'). With `roofline`, one more step before the trace
        is counted for phase 17 (`_count_step`). Returns the run's launch
        counts."""
        from repro_torch.configs.base import ShapeCell
        from repro_torch.optim.adamw import AdamW, cosine_schedule
        from repro_torch.training import train_loop as TL
        opt = AdamW(lr=cosine_schedule(1e-3, 2, steps), clip_norm=1.0)

        def make_state():
            params = self._seed_params(cfg)
            return TL.TrainState(params, opt.init(params))
        sc, seg = cfg.ssm, (cfg.n_layers // cfg.attn_every
                            if cfg.attn_every else 0)
        shared = (f", one shared attention block after each of {seg} "
                  f"segments (LoRA rank {cfg.shared_attn_lora_rank}, lora_b "
                  f"random)" if seg else "")
        print(f"      {cfg.name}: {cfg.n_layers} Mamba-2 layers, d_model "
              f"{cfg.d_model} d_inner {sc.expand * cfg.d_model} d_state "
              f"{sc.d_state} chunk {sc.chunk}{shared}; bf16 activations, "
              f"remat {cfg.remat}; {steps} donated AdamW steps at batch "
              f"{batch} x {seq}")
        batches = self._train_batches(cfg, steps + 1, batch, seq)
        run = self._train_run(TL.make_train_step(cfg, opt, donate=True),
                              make_state, batches[:steps],
                              self._recurrent_train_want(cfg),
                              falls=loss_falls)
        expect = ("matmul", "ssd", "ssd backward (plain)") + (
            ("gated_matmul", "flash_attention", "flash_attention_bwd")
            if seg else ())
        state = run.pop("state")
        if roofline:
            state, _ = self._count_step(
                f"{cfg.name} train step, remat {cfg.remat}", cfg,
                ShapeCell(f"train_{batch}x{seq}", "train", seq, batch),
                lambda: run["step_fn"](state, batches[steps]),
                run["steady"] * 1e3, "the steady step, host clock")
        self._trace_train_step(run["step_fn"], state, batches[steps],
                               expect)
        del state
        if remat_none:
            self._remat_none(cfg, opt, make_state, batches[:2], run,
                             donate=True)
        self._train_plain(cfg, opt, make_state, batches, run, plain_steps,
                          donate=True)
        return run["launches"]

    @staticmethod
    def _recurrent_train_want(cfg):
        """Launch counts of a train step of the ssm or hybrid family under
        remat "full". A Mamba-2 layer runs 3 GEMMs (in_proj, in_proj_bc,
        out_proj) and the SSD kernel in its forward, all again in its
        recompute, and 2 GEMMs (dx, dw) for each of the 3 in its backward
        (the SSD backward differentiates the plain scan: no kernel): 12
        GEMMs and 2 `ssd`. A hybrid segment's shared part (not
        rematerialised): 8 GEMMs (in_proj, Q, K, V, O, the down
        projection, the LoRA pair), the dual GEMM and the attention
        forward; in the backward 16 GEMMs for those 8, 6 for the dual GEMM
        (its gate/up recompute and their dw; dx of both branches) and the
        attention backward: 30 GEMMs. The logits: 1 GEMM and 2 in the
        backward."""
        n = cfg.n_layers
        seg = n // cfg.attn_every if cfg.attn_every else 0
        return _no_launches(matmul=12 * n + 30 * seg + 3, ssd=2 * n,
                            gated_matmul=seg, flash_attention=seg,
                            flash_attention_bwd=seg)

    # -- 9. Mamba-2 serving at full width -------------------------------
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
        from repro_torch.serving import ServingEngine
        cfg = get_config("mamba2-2.7b")
        L = cfg.n_layers
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = self._seed_params(cfg)
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
        print(f"[9/19] {cfg.name}: {L} layers d_model {cfg.d_model} d_inner "
              f"{sc.expand * cfg.d_model} ({sc.expand * cfg.d_model // sc.head_dim}"
              f" SSD heads of {sc.head_dim}) d_state {sc.d_state} groups "
              f"{sc.n_groups} conv {sc.conv_width} chunk {sc.chunk} vocab "
              f"{cfg.vocab}->{cfg.padded_vocab}; weights ready in "
              f"{time.perf_counter() - t0:.1f} s ({weights / 2 ** 30:.3f} GiB "
              f"on the card, bf16); {len(prompts)} requests, prompts "
              f"{lengths}, gen {gen}, 4 slots, max_len {eng.max_len}")
        _print_capture(eng)
        rem = sum(n % 8 if n >= 8 else 0 for n in lengths)
        self.mamba_launches, report = self._serve_checked(
            eng, prompts, gen, lambda e: _no_launches(
                matmul=(5 * L + 1) * len(lengths)
                + (3 * L + 1) * (e.decode_steps + rem), ssd=L * len(lengths)),
            "bf16")
        self._trace(eng, report["decode_step_p50_s"], n_steps=4,
                    expect=("matmul",), roofline=True)
        self._trace_prefill(eng, prompts[5])
        del eng
        torch.cuda.empty_cache()
        print(f"      after the engine: memory_allocated "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, "
              f"memory_reserved {torch.cuda.memory_reserved() / 2 ** 30:.3f} "
              f"GiB (the graphs' pools freed with it)")

        # int8 weights: the stacked in_proj, in_proj_bc, out_proj and
        # lm_head through matmul_q, as many as the bf16 run's GEMMs. The
        # f32 params are copied to the card again, so that the peaks of
        # both runs measure the engine alone.
        params = self._seed_params(cfg)
        eng = ServingEngine(cfg, params, max_slots=4,
                            max_len=max(lengths) + gen, device=self.dev,
                            quant="int8")
        del params
        torch.cuda.empty_cache()
        _print_capture(eng)
        self.mamba_int8_launches, _ = self._serve_checked(
            eng, prompts, gen, lambda e: _no_launches(
                matmul_q=(5 * L + 1) * len(lengths)
                + (3 * L + 1) * (e.decode_steps + rem), ssd=L * len(lengths)),
            "int8 weights", report["decode_step_p50_s"])
        del eng
        torch.cuda.empty_cache()

    def _serve_checked(self, eng, prompts, gen, want_fn, what,
                         p50_bf16=None, alone_kw=None, frames=None):
        """Serve `prompts` on `eng`, `gen` tokens each (an encdec request
        with its `frames`), with the launch
        counts set to 0 just before and read just after: they must be
        `want_fn(eng)`, and every stream the request run alone at batch 1:
        served by a 1-slot engine on `eng`'s weights (with the engine
        options `alone_kw`: a page pool's), one request at a time (its
        steps are graph replays too, where `_alone` steps eagerly: a
        Mamba-2 model's eager step is some 4,000 small launches; each
        replay equals its eager step, `_check_replay`). Prints the counts,
        speed and peak memory (the decode p50 beside `p50_bf16`, the bf16
        run's, where given). Returns (launches, report)."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.serving import ServingEngine
        torch.cuda.reset_peak_memory_stats()
        frames = frames or [None] * len(prompts)
        reqs = [eng.submit(pr, gen, enc_frames=f)
                for pr, f in zip(prompts, frames)]
        ops.reset_launch_counts()
        report = eng.run()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        assert report["n_finished"] == len(reqs), report
        for r in reqs:
            assert len(r.generated) == gen, (what, r.rid, r.generated)
            assert all(0 <= t < eng.cfg.vocab for t in r.generated), \
                r.generated
        want = want_fn(eng)
        print(f"      {what}: launches {launches} (expected {want}: "
              f"{len(reqs)} admission prefills, "
              f"{sum(n % 8 for n in map(len, prompts) if n >= 8)} remainder "
              f"tokens, {eng.decode_steps} decode steps)")
        assert launches == want, (what, launches, want)
        beside = "" if p50_bf16 is None \
            else f" (bf16 weights {p50_bf16 * 1e3:.2f} ms)"
        print(f"      {what}: prefill {report['prefill_tok_s']:.1f} tok/s, "
              f"decode {report['decode_tok_s']:.1f} tok/s (occupancy "
              f"{report['mean_occupancy']:.2f}/4), decode step p50 "
              f"{report['decode_step_p50_s'] * 1e3:.2f} ms{beside} p99 "
              f"{report['decode_step_p99_s'] * 1e3:.2f} ms, latency p50 "
              f"{report['latency_p50_s'] * 1e3:.0f} ms p95 "
              f"{report['latency_p95_s'] * 1e3:.0f} ms, ttft p50 "
              f"{report['ttft_p50_s'] * 1e3:.0f} ms p95 "
              f"{report['ttft_p95_s'] * 1e3:.0f} ms; max_memory_allocated "
              f"{peak / 2 ** 30:.3f} GiB")
        one = ServingEngine(eng.cfg, eng.params, max_slots=1,
                            max_len=eng.max_len, device=self.dev,
                            **(alone_kw or {}))
        alone = [one.submit(pr, gen, enc_frames=f)
                 for pr, f in zip(prompts, frames)]
        one.run()
        for req, solo, prompt in zip(reqs, alone, prompts):
            assert req.generated == solo.generated, \
                (what, req.rid, len(prompt))
        print(f"      {what}: the {len(reqs)} engine streams (decode at 4 "
              f"slots) equal each request served alone at batch 1 (a "
              f"1-slot engine), token for token")
        return launches, report

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
        _print_trace(prof, f"a {toks.shape[1]}-token prefill", wall_ms,
                     expect=("matmul", "ssd"))

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

    # -- 10. Zamba2 hybrid serving at full width ------------------------
    def _hybrid_params(self, cfg, device, gen_device="cpu"):
        """Random params from seed 0 (on `gen_device`'s generator) and a
        lora_b drawn from seed 1 (the host's): its init is zeros, and a
        LoRA path that computes nothing would pass every check."""
        torch = self.torch
        from repro_torch.models import model as M
        params = M.init_params(
            cfg, torch.Generator(device=gen_device).manual_seed(0), device)
        lb = params["hybrid"]["lora_b"]
        params["hybrid"]["lora_b"] = (
            torch.randn(lb.shape, generator=torch.Generator().manual_seed(1))
            * lb.shape[1] ** -0.5).to(lb)
        return params

    @staticmethod
    def _hybrid_want(eng, lengths, int8):
        """Launch counts of a hybrid run. A segment runs its Mamba layers
        (5 GEMMs at prefill with the SSD scan, 3 a one-token step), the
        shared in_proj, the LoRA pair, QKV/O, the SwiGLU dual GEMM and the
        down projection, and at a one-token step flash_decode; then the
        logits. With int8 weights the shared block, its in_proj and the
        logits take matmul_q (the dual GEMM as two), and the 4-D Mamba
        stacks and the LoRA pairs stay on the bf16 GEMM."""
        cfg = eng.cfg
        a, seg, n = cfg.attn_every, cfg.n_layers // cfg.attn_every, len(lengths)
        one = eng.decode_steps + sum(x % 8 for x in lengths if x >= 8)
        want = _no_launches(flash_decode=seg * one, ssd=cfg.n_layers * n)
        if int8:
            want.update(matmul=seg * (5 * a + 2) * n + seg * (3 * a + 2) * one,
                        matmul_q=(8 * seg + 1) * (n + one))
        else:
            want.update(matmul=(seg * (5 * a + 8) + 1) * n
                        + (seg * (3 * a + 8) + 1) * one,
                        gated_matmul=seg * (n + one))
        return want

    def phase_hybrid(self):
        """zamba2-1.2b served on 4 slots to 8 requests, 32 tokens each, in
        bf16 and with int8 weights. The prompts take every prefill branch
        of its chunk of 128: 64 and 97 (shorter than a chunk; 97 a bucket
        remainder), 128, 256 and 512 (whole chunks), 200, 333 and 397
        (ragged, padded; 333 and 397 remainders). Each run: exact launch
        counts (the SSD kernel in every admission prefill, flash_decode at
        D = 64 in every step), each stream equal to the request alone, a
        replay against the eager step and a trace of decode steps; the
        memory back after each engine goes."""
        torch = self.torch
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.core.tree import leaves
        from repro_torch.serving import ServingEngine
        cfg = get_config("zamba2-1.2b")
        sc, dh = cfg.ssm, cfg.resolved_head_dim
        seg = cfg.n_layers // cfg.attn_every
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = self._seed_params(cfg)
        n_params = sum(t.numel() for t in leaves(params))
        lengths = [64, 97, 128, 200, 256, 333, 397, 512]
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
                   for n in lengths]
        gen = 32
        eng = ServingEngine(cfg, params, max_slots=4,
                            max_len=max(lengths) + gen, device=self.dev)
        del params                      # the engine keeps its bf16 copy
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        engine_bytes = torch.cuda.memory_allocated() - base
        print(f"[10/19] {cfg.name}: {cfg.n_layers} Mamba-2 layers in {seg} "
              f"segments of {cfg.attn_every}, d_model {cfg.d_model} d_inner "
              f"{sc.expand * cfg.d_model} ({sc.expand * cfg.d_model // sc.head_dim}"
              f" SSD heads of {sc.head_dim}) d_state {sc.d_state} conv "
              f"{sc.conv_width} chunk {sc.chunk}; one shared attention block "
              f"after each segment (heads {cfg.n_heads}/{cfg.n_kv_heads}x{dh}, "
              f"d_ff {cfg.d_ff}, in_proj {2 * cfg.d_model}->{cfg.d_model}, "
              f"LoRA rank {cfg.shared_attn_lora_rank} a segment, lora_b "
              f"random); vocab {cfg.vocab}; {n_params / 1e9:.3f} G params "
              f"ready in {time.perf_counter() - t0:.1f} s; the engine's bf16 "
              f"weights and caches {engine_bytes / 2 ** 30:.3f} GiB on the "
              f"card; {len(prompts)} requests, prompts {lengths}, gen {gen}, "
              f"4 slots, max_len {eng.max_len}")
        _print_capture(eng)
        self.hybrid_launches, report = self._serve_checked(
            eng, prompts, gen, lambda e: self._hybrid_want(e, lengths, False),
            "bf16")
        streams = [r.generated for r in eng.requests[:len(prompts)]]
        self._trace(eng, report["decode_step_p50_s"], n_steps=4,
                    expect=("matmul", "gated_matmul", "flash_decode"))
        self._hybrid_rebuild(eng, prompts[:4], streams[:4], gen)
        del eng
        self._memory_back(base, "bf16")

        # the f32 params copied to the card again, so that the peaks of
        # both runs measure the engine alone
        params = self._seed_params(cfg)
        eng = ServingEngine(cfg, params, max_slots=4,
                            max_len=max(lengths) + gen, device=self.dev,
                            quant="int8")
        del params
        torch.cuda.empty_cache()
        _print_capture(eng)
        self.hybrid_int8_launches, _ = self._serve_checked(
            eng, prompts, gen, lambda e: self._hybrid_want(e, lengths, True),
            "int8 weights", report["decode_step_p50_s"])
        del eng
        self._memory_back(base, "int8 weights")

    def _hybrid_rebuild(self, eng, prompts, streams, gen, kernel=(3, 10)):
        """Phase 10's rebuild run: a fresh engine on `eng`'s weights with
        kernel faults scripted at decode steps 3 and 10, 4 requests on 4
        slots, so the rebuild of the captured steps falls mid-trace with
        every Mamba state busy. Every stream must be its request's from
        the fault-free run (`streams`, each its request alone), the
        launch counts the fault-free formula's (the rebuild's warm-ups
        and captures taken out), and no decode step after the rebuild
        calls a kernel wrapper."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.serving import FaultInjector, ServingEngine
        one = ServingEngine(eng.cfg, eng.params, max_slots=4,
                            max_len=eng.max_len, device=self.dev,
                            fault_injector=FaultInjector(
                                kernel_fail_steps=kernel))
        before = dict(one._step.launches)
        reqs = [one.submit(p, gen) for p in prompts]
        ops.reset_launch_counts()
        while not one.degraded:
            assert one.step(), "the run drained before the rebuild"
        active = one.scheduler.n_active
        with _wrapper_calls() as calls:
            rep = one.run()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        assert not calls, f"a step after the rebuild called {calls}"
        assert rep["kernel_faults"] == 2 and rep["crashed_steps"] == 0, rep
        assert active == 4 and one._step.launches == before
        assert [r.generated for r in reqs] == streams, \
            "a stream across the rebuild differs from the fault-free run's"
        want = self._hybrid_want(one, [len(p) for p in prompts], False)
        assert launches == want, (launches, want)
        print(f"      rebuild run: kernel faults at decode steps {kernel}, "
              f"the captured steps rebuilt at step {kernel[1]} with "
              f"{active} Mamba states busy in {one.rebuild_s:.3f} s (graph "
              f"pools {one.graph_pool_bytes / 2 ** 20:.2f} MiB): the "
              f"{len(reqs)} streams equal the fault-free run's (each its "
              f"request alone), launches {_nonzero(launches)} (the "
              f"fault-free formula's), no "
              f"kernel wrapper called by {one.decode_steps - kernel[1] - 1} "
              f"decode steps after it")
        del one

    def _memory_back(self, base, what):
        """Once the caller has dropped its engine, the card's allocated
        memory must come back to `base`, what it was before the engine and
        its f32 params were made."""
        torch = self.torch
        import gc
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        now = torch.cuda.memory_allocated()
        print(f"      {what}: after the engine goes, memory_allocated "
              f"{now / 2 ** 30:.3f} GiB (before it {base / 2 ** 30:.3f} GiB), "
              f"memory_reserved {torch.cuda.memory_reserved() / 2 ** 30:.3f} "
              f"GiB")
        assert now == base, (what, now, base)

    def phase_hybrid_vs_cpu(self, length=300, steps=4, tol=1e-4):
        """zamba2-1.2b at full width and depth 2 (two segments of one Mamba
        layer: both LoRA pairs, both KV caches), f32 activations, lora_b
        random: a prefill of a 300-token prompt (two whole chunks and a
        padded ragged one) and 4 decode steps on the card (the CUDA
        kernels) and on the CPU (their plain versions) from the same
        weights: logits and every cache leaf within rtol 1e-4, atol 1e-4 x
        the largest |value| (f32 sums in another order)."""
        torch = self.torch
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.core.tree import leaves, tree_map
        from repro_torch.models import model as M
        cfg = dataclasses.replace(get_config("zamba2-1.2b"), n_layers=2,
                                  attn_every=1, dtype="float32")
        params = self._hybrid_params(cfg, "cpu")
        toks = torch.randint(0, cfg.vocab, (1, length + steps),
                             generator=torch.Generator().manual_seed(1))
        # a KV length past attn_chunk is a whole number of chunks
        a = cfg.attn_chunk
        max_len = length + steps if length + steps <= a \
            else -(-(length + steps) // a) * a
        out = []
        for dev in (self.dev, torch.device("cpu")):
            p = tree_map(lambda x: x.to(dev), params)
            cache = M.init_cache(cfg, 1, max_len, dev)
            t0 = time.perf_counter()
            logits, cache = M.prefill(cfg, p, {"tokens": toks[:, :length]
                                               .to(dev)}, cache)
            logs = [logits]
            for i in range(steps):
                logits, cache = M.decode_step(
                    cfg, p, toks[:, length + i:length + i + 1].to(dev),
                    length + i, cache)
                logs.append(logits)
            got = [t.cpu() for t in logs] + [v.cpu() for v in leaves(cache)]
            out.append((got, time.perf_counter() - t0))
        (card, tc), (cpu, tp) = out
        worst = 0.0
        for x, y in zip(card, cpu):
            assert torch.isfinite(x).all(), "non-finite output on the card"
            scale = y.abs().max().item()
            torch.testing.assert_close(x, y, rtol=tol, atol=tol * scale)
            worst = max(worst, ((x - y).abs().max() / scale).item())
        print(f"      depth 2 (2 segments of 1 Mamba layer), f32, a {length}-"
              f"token prefill and {steps} decode steps: card ({tc * 1e3:.0f} "
              f"ms) against CPU ({tp * 1e3:.0f} ms): logits, KV caches and "
              f"states within rtol {tol:g}; max |diff| / max |value| "
              f"{worst:.2e}")

    # -- 11. the dense configs and vlm at full width ------------------------
    def _config_params(self, cfg):
        """cfg's random params drawn on the card from a CUDA generator of
        seed 0 and held in bf16 (the engine's compute dtype, so its cast
        makes no copy; granite-3-8b's f32 params alone would take 33
        GB), the QKV biases, which init_params starts at zeros, from one
        of seed 1 (a bias of zeros passes any check)."""
        torch = self.torch
        import dataclasses
        from repro_torch.models import model as M
        params = M.init_params(
            dataclasses.replace(cfg, param_dtype="bfloat16"),
            torch.Generator(device=self.dev).manual_seed(0), self.dev)
        gen = torch.Generator(device=self.dev).manual_seed(1)
        attn = params["layers"]["attn"]
        for name in ("wq", "wk", "wv"):
            if "b" in attn[name]:
                b = attn[name]["b"]
                attn[name]["b"] = (torch.randn(
                    b.shape, generator=gen, device=self.dev) * 0.1).to(b.dtype)
        return params

    @staticmethod
    def _dense_want(eng, prompts, int8=False, tied=True):
        """Launch counts of a run of a dense-family model on a dense cache:
        every admission prefill and every one-token step (a decode step,
        or an admission's remainder token) runs 5 GEMMs a layer (Q, K, V,
        O, the down projection with its residual; Q, K, V with the bias
        epilogue where the config has QKV biases), the dual GEMM and the
        logits; a one-token step adds decode attention a layer. With int8
        weights each layer runs 7 int8-weight GEMMs (the dual GEMM as
        two), and so does an untied lm_head."""
        L = eng.cfg.n_layers
        rem = sum(len(p) % 8 for p in prompts if len(p) >= 8)
        one = eng.decode_steps + rem
        runs = one + len(prompts)
        want = _no_launches(flash_decode=L * one)
        if int8:
            want.update(matmul_q=(7 * L + (0 if tied else 1)) * runs,
                        matmul=runs if tied else 0)
        else:
            want.update(matmul=(5 * L + 1) * runs, gated_matmul=L * runs)
        return want

    def _bias_epilogues(self, eng, prompt):
        """GEMM launches with the bias epilogue in one eager prefill of
        `prompt` at batch 1 and one eager decode step after it, counted at
        the wrappers: 3 a layer (Q, K, V) in each where the config has QKV
        biases, else none."""
        torch = self.torch
        from repro_torch.kernels import matmul as mm
        from repro_torch.models import model as M
        seen = []
        saved = mm.matmul_tiled, mm.matmul_q_tiled

        def wrap(fn):
            def counted(*args, **kw):
                seen.append(kw.get("epilogue", "none"))
                return fn(*args, **kw)
            return counted
        mm.matmul_tiled, mm.matmul_q_tiled = map(wrap, saved)
        try:
            toks = torch.as_tensor(prompt, dtype=torch.long, device=self.dev)
            cache = M.init_cache(eng.cfg, 1, eng.max_len, self.dev)
            _, cache = M.prefill(eng.cfg, eng.params, {"tokens": toks[None]},
                                 cache)
            n_pre = seen.count("bias")
            M.decode_step(eng.cfg, eng.params, toks[None, :1], len(prompt),
                          cache)
        finally:
            mm.matmul_tiled, mm.matmul_q_tiled = saved
        want = 3 * eng.cfg.n_layers if eng.cfg.qkv_bias else 0
        assert (n_pre, seen.count("bias") - n_pre) == (want, want), \
            (n_pre, seen.count("bias") - n_pre, want)
        return want

    def _serve_config(self, cfg, params, work, what, int8=False, trace=2):
        """One engine run of `work` on 4 slots (dense cache) of cfg from
        `params` (bf16 weights, or int8 with `int8`): the capture, exact
        launch counts, the bias epilogue's launches (`_bias_epilogues`),
        every stream equal to its request alone at batch 1, speed, time to
        first token and memory (`_serve_checked`), then a replay against
        the eager step and a trace of `trace` decode steps (`_trace`).
        Returns (engine, launches, report)."""
        from repro_torch.serving import ServingEngine
        max_len = -(-max(len(it.prompt) + it.gen for it in work) // 16) * 16
        eng = ServingEngine(cfg, params, max_slots=4, max_len=max_len,
                            device=self.dev, quant="int8" if int8 else "off")
        _print_capture(eng)
        prompts = [it.prompt for it in work]
        tied = cfg.tie_embeddings
        launches, report = self._serve_checked(
            eng, prompts, work[0].gen,
            lambda e: self._dense_want(e, prompts, int8, tied), what)
        n_bias = self._bias_epilogues(eng, prompts[0])
        print(f"      {what}: the bias epilogue: {n_bias} GEMM launches of "
              f"an eager prefill, and {n_bias} of an eager decode step "
              f"(Q, K and V of each of {cfg.n_layers} layers)")
        self._trace(eng, report["decode_step_p50_s"], n_steps=trace,
                    expect=("matmul_q" if int8 else "gated_matmul",
                            "flash_decode"))
        return eng, launches, report

    def phase_dense_configs(self, cut_depth=8):
        """qwen2-vl-2b (vlm) at full width and depth: 8 requests of 64-512
        prompt tokens on 4 slots, 32 generated each, on the dense cache
        (`_serve_config`), then on a bf16 page pool (phase 4's streams bit
        for bit), then as a speculative target with itself as the draft (k
        = 4: every proposal accepted, the same streams); then a multimodal
        prompt (text, a 16 x 16 image's patch embeddings at their (t, h,
        w) positions, text) through prefill and decode steps at depth 2 in
        f32 on the card against the CPU. granite-3-8b at full width and
        depth, 4 requests, in bf16 and with int8 weights; granite-20b
        (MQA) and qwen1.5-32b (MHA, QKV biases) at full width and
        `cut_depth` layers (their full depths, about 28 G and 34 G params,
        do not fit one card beside their caches), 4 requests each, and
        qwen1.5-32b's again with int8 weights (matmul_q with the bias
        epilogue). Every model's params are drawn on the card and held in
        bf16 (`_config_params`); the memory comes back after each."""
        torch = self.torch
        import dataclasses
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.core.tree import leaves
        from repro_torch.serving import ServingEngine, synthetic_trace
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        self.config_launches = {}

        def header(cfg, params, t0, depth=""):
            n = sum(t.numel() for t in leaves(params))
            mrope = f", M-RoPE {cfg.mrope_sections}" \
                if cfg.mrope_sections else ""
            print(f"      {cfg.name}{depth}: {cfg.n_layers} layers d_model "
                  f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads}x"
                  f"{cfg.resolved_head_dim} (a group of "
                  f"{cfg.n_heads // cfg.n_kv_heads}) d_ff {cfg.d_ff} vocab "
                  f"{cfg.vocab}->{cfg.padded_vocab}"
                  f"{', QKV biases' if cfg.qkv_bias else ''}"
                  f"{mrope}"
                  f"{', tied embeddings' if cfg.tie_embeddings else ''}; "
                  f"{n / 1e9:.3f} G params drawn on the card (seed 0, QKV "
                  f"biases seed 1), held in bf16 "
                  f"({torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB on "
                  f"the card), in {time.perf_counter() - t0:.1f} s")

        # -- qwen2-vl-2b: dense, paged bf16, speculative; multimodal
        cfg = get_config("qwen2-vl-2b")
        L = cfg.n_layers
        print(f"[11/19] the dense configs and vlm at full width (random "
              f"weights, bf16, 4 slots, 32 tokens a request)")
        t0 = time.perf_counter()
        params = self._config_params(cfg)
        header(cfg, params, t0)
        work = synthetic_trace(cfg, 8, rng=np.random.default_rng(0),
                               len_range=(64, 512), gen=32)
        print(f"      {cfg.name}: {len(work)} requests, prompts "
              f"{[len(it.prompt) for it in work]}")
        eng, launches, report = self._serve_config(
            cfg, params, work, f"{cfg.name} dense", trace=4)
        self.config_launches[cfg.name] = launches
        streams = [list(r.generated) for r in eng.requests[:len(work)]]
        max_len = eng.max_len
        del eng
        eng = ServingEngine(cfg, params, max_slots=4, max_len=max_len,
                            device=self.dev, kv_layout="paged")
        reqs, rep, launches = self._run_counted(eng, work)
        want = self._want_launches(eng, reqs, {"matmul": 5 * L + 1,
                                               "gated_matmul": L})
        assert launches == want, (launches, want)
        assert [r.generated for r in reqs] == streams, \
            "paged bf16 streams != the dense cache's"
        self.config_launches[cfg.name + " paged"] = launches
        print(f"      {cfg.name} paged bf16 KV (page 16, "
              f"{rep['kv_pool']['n_pages']} pages): the dense run's "
              f"{len(reqs)} streams, token for token; launches "
              f"{_nonzero(launches)} (exact); decode step p50 "
              f"{rep['decode_step_p50_s'] * 1e3:.2f} ms p99 "
              f"{rep['decode_step_p99_s'] * 1e3:.2f} ms, ttft p50 "
              f"{rep['ttft_p50_s'] * 1e3:.0f} ms")
        del eng
        eng = ServingEngine(cfg, params, max_slots=4, max_len=max_len,
                            device=self.dev, draft=(cfg, params), spec_k=4)
        reqs, rep, launches = self._run_counted(eng, work)
        assert [r.generated for r in reqs] == streams, \
            "speculative streams != the dense run's"
        assert rep["spec_acceptance_rate"] == 1.0, rep["spec_acceptance_rate"]
        assert launches["flash_decode_rows"] == L * rep["spec_rounds"], \
            (launches, rep["spec_rounds"])
        self.config_launches[cfg.name + " speculative"] = launches
        print(f"      {cfg.name} speculative, itself the draft, k=4: the "
              f"dense run's streams; {rep['spec_rounds']} rounds, "
              f"acceptance {rep['spec_acceptance_rate']:.3f} "
              f"({rep['spec_accepted']}/{rep['spec_proposed']}), "
              f"flash_decode_rows {L} a round; round p50 "
              f"{rep['decode_step_p50_s'] * 1e3:.2f} ms (the dense decode "
              f"step's {report['decode_step_p50_s'] * 1e3:.2f}); capture "
              f"{eng.capture_s:.2f} s")
        del eng, params
        self._memory_back(base, cfg.name)
        self._multimodal_vs_cpu(cfg)

        # -- granite-3-8b at full depth (bf16, int8); granite-20b and
        #    qwen1.5-32b at `cut_depth` layers
        runs = (("granite-3-8b", None, True),
                ("granite-20b", cut_depth, False),
                ("qwen1.5-32b", cut_depth, True))
        for name, depth, int8 in runs:
            cfg = get_config(name)
            full = cfg.n_layers
            if depth is not None:
                cfg = dataclasses.replace(cfg, n_layers=depth)
            t0 = time.perf_counter()
            params = self._config_params(cfg)
            header(cfg, params, t0, "" if depth is None
                   else f" ({depth} of its {full} layers)")
            work = synthetic_trace(cfg, 4, rng=np.random.default_rng(0),
                                   len_range=(64, 512), gen=32)
            print(f"      {cfg.name}: {len(work)} requests, prompts "
                  f"{[len(it.prompt) for it in work]}")
            key = name if depth is None else f"{name} ({depth} layers)"
            eng, self.config_launches[key], report = self._serve_config(
                cfg, params, work, f"{name} bf16")
            del eng
            if int8:
                eng, self.config_launches[key + " int8"], _ = \
                    self._serve_config(cfg, params, work, f"{name} int8 "
                                       f"weights", int8=True)
                del eng
            del params
            self._memory_back(base, name)

    def _multimodal_vs_cpu(self, cfg, steps=4, tol=1e-4):
        """qwen2-vl-2b at full width and depth 2, f32: a multimodal prompt
        (8 text tokens, a 16 x 16 image's 256 patch embeddings at their
        (t, h, w) positions, 16 text tokens) through prefill, then 4 text
        decode steps (t = h = w = pos), on the card (the CUDA kernels) and
        on the CPU (their plain versions) from the same weights: logits
        and the KV cache within rtol 1e-4, atol 1e-4 x the largest |value|;
        and the patch embeddings move the logits."""
        torch = self.torch
        import dataclasses
        import numpy as np
        from repro_torch.core.tree import leaves, tree_map
        from repro_torch.data.pipeline import multimodal_prompt
        from repro_torch.models import model as M
        cfg = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                                  param_dtype="float32")
        params = tree_map(lambda t: t.float().cpu(), self._config_params(cfg))
        b = multimodal_prompt(np.random.default_rng(0), cfg.vocab,
                              cfg.d_model, before=8, grid=(16, 16), after=16)
        t = b["tokens"].shape[1]
        nxt = np.random.default_rng(1).integers(0, cfg.vocab, (1, steps))
        # a KV length past attn_chunk is a whole number of chunks
        a = cfg.attn_chunk
        max_len = t + steps if t + steps <= a else -(-(t + steps) // a) * a
        out = []
        for dev in (self.dev, torch.device("cpu")):
            p = tree_map(lambda x: x.to(dev), params)
            batch = {"tokens": torch.as_tensor(b["tokens"], dtype=torch.long),
                     "patch_embeds": torch.as_tensor(b["patch_embeds"]),
                     "positions": torch.as_tensor(b["positions"],
                                                  dtype=torch.long)}
            batch = {k: v.to(dev) for k, v in batch.items()}
            t0 = time.perf_counter()
            cache = M.init_cache(cfg, 1, max_len, dev)
            logits, cache = M.prefill(cfg, p, batch, cache)
            logs = [logits]
            for i in range(steps):
                tok = torch.as_tensor(nxt[:, i:i + 1], dtype=torch.long,
                                      device=dev)
                logits, cache = M.decode_step(cfg, p, tok, t + i, cache)
                logs.append(logits)
            got = [x.cpu() for x in logs] + [v.cpu() for v in leaves(cache)]
            out.append((got, time.perf_counter() - t0))
            if dev == self.dev:
                text, _ = M.prefill(cfg, p, {"tokens": batch["tokens"]},
                                    M.init_cache(cfg, 1, max_len, dev))
                moved = (text - logs[0]).abs().max().item()
        (card, tc), (cpu, tp) = out
        worst = 0.0
        for x, y in zip(card, cpu):
            assert torch.isfinite(x).all(), "non-finite output on the card"
            scale = y.abs().max().item()
            torch.testing.assert_close(x, y, rtol=tol, atol=tol * scale)
            worst = max(worst, ((x - y).abs().max() / scale).item())
        assert moved > 1e-3, moved
        print(f"      {cfg.name} multimodal, depth 2, f32: a {t}-token prompt "
              f"(8 text, 16 x 16 patches at (t, h, w), 16 text) and {steps} "
              f"decode steps: card ({tc * 1e3:.0f} ms) against CPU "
              f"({tp * 1e3:.0f} ms): logits and KV cache within rtol {tol:g}; "
              f"max |diff| / max |value| {worst:.2e}; the image moves the "
              f"last logits by up to {moved:.3f} against the tokens alone")

    # -- 12. the moe family at full width --------------------------------
    @staticmethod
    def _moe_per_step(cfg, int8=False):
        """GEMM launches of one prefill or one-token step of a moe model:
        a layer runs Q, K, V and O, the f32 router GEMM, the batched dual
        GEMM and the batched down GEMM (Arctic: its dense branch, a dual
        GEMM and a GEMM), and the step the lm_head's logits. With int8
        weights Q, K, V, O, the lm_head and the dense branch (its dual GEMM
        as two) take the int8-weight GEMM; the router and the banks stay
        float, as the reference's walk leaves them."""
        L = cfg.n_layers
        dense = bool(cfg.moe.dense_ff)
        want = {"matmul_batched": L, "gated_matmul_batched": L}
        if int8:
            want.update(matmul=L, matmul_q=4 * L + 1 + 3 * L * dense)
        else:
            want.update(matmul=5 * L + 1 + L * dense)
            if dense:
                want["gated_matmul"] = L
        return want

    def _serve_moe(self, cfg, params, work, what, trace=2, expect=(),
                   roofline=False, **kw):
        """One engine run of `work` on 4 slots of cfg from `params` (engine
        options `kw`: a page pool, int8 pages, int8 weights) through
        `_serve_checked` (exact launch counts, `_moe_per_step`; speed,
        time to first token, peak memory; every stream equal to its
        request on a 1-slot engine of the same cache layout), then a
        replay against the eager step (with `roofline`, counted for phase
        17) and a trace of `trace` decode steps in which the groups
        `expect` must show (`_trace`). Returns
        (engine, launches, report, streams)."""
        from repro_torch.serving import ServingEngine
        max_len = -(-max(len(it.prompt) + it.gen for it in work) // 16) * 16
        eng = ServingEngine(cfg, params, max_slots=4, max_len=max_len,
                            device=self.dev, **kw)
        _print_capture(eng)
        prompts = [it.prompt for it in work]
        per_step = self._moe_per_step(cfg, kw.get("quant") == "int8")

        def want(e):
            L = cfg.n_layers
            rem = sum(len(p) % 8 for p in prompts if len(p) >= 8)
            runs = e.decode_steps + rem + len(prompts)
            w = _no_launches(**{k: n * runs for k, n in per_step.items()})
            if e.pool is None:
                w["flash_decode"] = L * (rem + e.decode_steps)
            else:
                w.update(flash_decode=L * rem,
                         flash_decode_paged=L * e.decode_steps)
            return w

        alone_kw = {k: v for k, v in kw.items() if k != "quant"}
        if eng.pool is not None:         # a request reserves its write range
            alone_kw["kv_pool_pages"] = eng.pool.n_pages
        launches, report = self._serve_checked(
            eng, prompts, work[0].gen, want, what, alone_kw=alone_kw)
        streams = [list(r.generated) for r in eng.requests[:len(work)]]
        self._trace(eng, report["decode_step_p50_s"], n_steps=trace,
                    expect=expect, roofline=roofline)
        return eng, launches, report, streams

    def phase_moe(self, mixtral_layers=4, arctic_layers=2):
        """The moe family at full width, random weights drawn on the card
        (a CUDA generator of seed 0) in bf16 but the f32 router, 4 slots,
        32 tokens a request. mixtral-8x22b at `mixtral_layers` of its 56
        layers (5.0 GB a layer in bf16: its 56 do not fit one card): phase
        4's trace (8 requests of 64-512 tokens) on the dense cache and on a
        bf16 page pool (the same streams), and as its own speculative
        draft on the dense cache (`_moe_spec`); one request of 4,608 prompt
        tokens and 32 new ones, past the 4096-token window, its stream
        equal to its eager prefill and batch-1 decode steps; int8 weights
        on an int8 pool, 4 requests. arctic-480b at `arctic_layers` of its
        35 (27.3 GB a layer), 4 requests on the dense cache. Each engine
        run (`_serve_moe`): exact launch counts, one batched dual GEMM and
        one batched GEMM a layer a step; each stream equal to its request
        alone; a replay against the eager step; a trace; decode p50 and
        p99, time to first token, peak memory, capture time; the memory
        back to the params' own after each engine, and to the phase's
        start after each model. Then both at the reduced widths and depth
        2, f32, on the card against the CPU (`_moe_vs_cpu`)."""
        torch = self.torch
        import dataclasses
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.core.tree import leaves
        from repro_torch.serving import synthetic_trace
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        self.moe_launches = {}
        print(f"[12/19] the moe family at full width (random weights drawn "
              f"on the card, bf16 but the f32 router, 4 slots, 32 tokens a "
              f"request)")

        def model(name, depth):
            cfg = get_config(name)
            full = cfg.n_layers
            cfg = dataclasses.replace(cfg, n_layers=depth)
            t0 = time.perf_counter()
            params = self._config_params(cfg)
            torch.cuda.synchronize()
            n = sum(t.numel() for t in leaves(params))
            mc = cfg.moe
            print(f"      {name} ({depth} of its {full} layers): d_model "
                  f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads}x"
                  f"{cfg.resolved_head_dim} (a group of "
                  f"{cfg.n_heads // cfg.n_kv_heads}) d_ff {cfg.d_ff}, "
                  f"{mc.n_experts} experts top-{mc.top_k} capacity factor "
                  f"{mc.capacity_factor} groups of {mc.group_size}"
                  f"{f', dense branch {mc.dense_ff}' if mc.dense_ff else ''}"
                  f"{f', window {cfg.window}' if cfg.window else ''}, vocab "
                  f"{cfg.vocab}->{cfg.padded_vocab}; {n / 1e9:.3f} G params "
                  f"drawn on the card ({torch.cuda.memory_allocated() / 2 ** 30:.3f} "
                  f"GiB) in {time.perf_counter() - t0:.1f} s")
            return cfg, params

        # -- mixtral-8x22b: dense, bf16 pool, past the window, int8; after
        #    each engine the memory comes back to the params' own
        name = "mixtral-8x22b"
        cfg, params = model(name, mixtral_layers)
        held = torch.cuda.memory_allocated()
        work = synthetic_trace(cfg, 8, rng=np.random.default_rng(0),
                               len_range=(64, 512), gen=32)
        print(f"      {name}: {len(work)} requests, prompts "
              f"{[len(it.prompt) for it in work]}")
        key = f"{name} ({mixtral_layers} layers)"
        eng, self.moe_launches[key], report, streams = self._serve_moe(
            cfg, params, work, f"{name} dense", trace=4,
            expect=("gated_matmul_batched", "matmul_batched", "flash_decode"),
            roofline=True)
        self.moe_p50 = {key: report["decode_step_p50_s"]}
        del eng
        self._memory_back(held, f"{name} dense")
        for run, counts in self._moe_spec(cfg, params, work,
                                          streams).items():
            self.moe_launches[f"{key} {run}"] = counts
        self._memory_back(held, f"{name} speculative")
        eng, self.moe_launches[key + " paged"], rep, paged = self._serve_moe(
            cfg, params, work, f"{name} paged bf16", kv_layout="paged",
            expect=("gated_matmul_batched", "matmul_batched",
                    "flash_decode_paged"))
        assert paged == streams, "paged bf16 streams != the dense cache's"
        print(f"      {name} paged bf16 KV ({rep['kv_pool']['n_pages']} "
              f"pages of 16): the dense run's {len(streams)} streams, token "
              f"for token")
        del eng
        self._memory_back(held, f"{name} paged bf16")
        self._moe_long(cfg, params)
        self._memory_back(held, f"{name} past the window")
        eng, self.moe_launches[key + " int8"], rep, _ = self._serve_moe(
            cfg, params, work[:4], f"{name} int8 weights, int8 pool",
            kv_layout="paged", quant_kv="int8", quant="int8",
            expect=("matmul_q", "gated_matmul_batched", "matmul_batched",
                    "flash_decode_paged"))
        print(f"      {name} int8: decode step p50 "
              f"{rep['decode_step_p50_s'] * 1e3:.2f} ms (bf16 weights, dense "
              f"cache: {report['decode_step_p50_s'] * 1e3:.2f} ms)")
        del eng
        self._memory_back(held, f"{name} int8")
        del params
        self._memory_back(base, name)

        # -- arctic-480b: dense cache
        name = "arctic-480b"
        cfg, params = model(name, arctic_layers)
        held = torch.cuda.memory_allocated()
        work = synthetic_trace(cfg, 4, rng=np.random.default_rng(0),
                               len_range=(64, 512), gen=32)
        print(f"      {name}: {len(work)} requests, prompts "
              f"{[len(it.prompt) for it in work]}")
        key = f"{name} ({arctic_layers} layers)"
        eng, self.moe_launches[key], report, _ = self._serve_moe(
            cfg, params, work, f"{name} dense", expect=(
                "gated_matmul_batched", "matmul_batched", "gated_matmul",
                "flash_decode"))
        self.moe_p50[key] = report["decode_step_p50_s"]
        del eng
        self._memory_back(held, f"{name} dense")
        del params
        self._memory_back(base, name)
        for name in ("mixtral-8x22b", "arctic-480b"):
            self._moe_vs_cpu(name)

    def _moe_spec(self, cfg, params, work, streams, k=4, check_round=2):
        """Greedy speculative decoding with `cfg` as the target and its own
        draft: `work` on 4 slots at spec_k `k`, the dense cache. A verify
        step routes its 4 x (k + 1) rows as one group (capacity 6 an
        expert for 20 rows at top-2 of 8), so rounds can drop
        assignments, its zero rows' among them (idle slots, rows past
        n_tok). The launch counts are set to 0 just before the run and
        read just after; the run's own wrapper of the verify step only
        copies, on the card, each round's block, argmax rows and drops,
        and round `check_round`'s (every slot busy) inputs, cache and
        outputs. Checks, after the counts are read: the verify graph's
        launches (a layer's Q, K, V, O and f32 router GEMMs, its batched
        dual GEMM and batched GEMM, its multi-row decode attention; the
        logits GEMM), the multi-row decode's L a round exactly; every
        request's stream is its first token and then, round by round, the
        greedy rule's tokens on that round's verify logits; round
        `check_round` against an eager `M.verify_step` on a clone of its
        block and cache, logits and drops bit for bit, and against the
        plain versions on another clone, each real row whose routing (top-k
        ids and kept assignments at every layer) is the kernels' within
        2^-4 of its norm; the streams of the requests whose real rows
        dropped nothing equal the dense run's (`streams`). Prints the
        acceptance, each round's dropped fraction (real rows, all rows),
        the launch counts and the round's p50. Then the first 2 requests
        on 1 slot at k = 3, on the dense cache and on a bf16 page pool,
        where a round's 4 rows fit the capacity of 4 and none can drop:
        their streams must be the dense run's, every proposal accepted,
        the multi-row decode (dense or paged) L launches a round. Returns
        {run: launch counts}."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.models import model as M
        from repro_torch.models import moe as PMoE
        from repro_torch.serving import ServingEngine
        L, top = cfg.n_layers, cfg.moe.top_k
        max_len = -(-max(len(it.prompt) + it.gen for it in work) // 16) * 16
        eng = ServingEngine(cfg, params, max_slots=4, max_len=max_len,
                            device=self.dev, draft=(cfg, params), spec_k=k)
        _print_capture(eng)
        per_round = _no_launches(matmul=5 * L + 1, matmul_batched=L,
                                 gated_matmul_batched=L,
                                 flash_decode_rows=L)
        graph = _no_launches(**eng._verify_step.launches)
        print(f"      {cfg.name} spec, target as its own draft, k={k}: the "
              f"verify graph launches {_nonzero(graph)}")
        assert graph == per_round, (graph, per_round)
        replay = eng._verify_step
        rounds, saved = [], {}

        def verify_step():
            """The graph's replay; copies on the card, no kernel wrapper."""
            if eng.spec_rounds == check_round:
                saved.update(args=(eng._v_tokens.clone(),
                                   eng._step_pos.clone(),
                                   eng._v_ntok.clone()),
                             cache=_clone_tree(eng.cache),
                             plain_cache=_clone_tree(eng.cache))
            logits = replay()
            rounds.append(dict(
                top=logits[..., :cfg.vocab].argmax(-1), drops=eng._v_drops
                .clone(), tokens=eng._v_tokens.clone(),
                n_tok=eng._v_ntok.clone(),
                rids={s: r.rid for s, r in eng.scheduler.active.items()}))
            if eng.spec_rounds == check_round:
                saved.update(logits=logits.clone(),
                             drops=eng._v_drops.clone())
            return logits
        eng._verify_step = verify_step
        reqs = [eng.submit(it.prompt, it.gen) for it in work]
        ops.reset_launch_counts()
        rep = eng.run()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        eng._verify_step = replay
        assert rep["n_finished"] == len(reqs), rep
        n_rounds = rep["spec_rounds"]
        assert len(rounds) == n_rounds, (len(rounds), n_rounds)
        assert launches["flash_decode_rows"] == L * n_rounds, \
            (launches, n_rounds)
        assert launches["matmul_batched"] >= L * n_rounds, launches
        assert saved, f"round {check_round} was not reached"
        rounds = [{key: v.cpu().numpy() if torch.is_tensor(v) else v
                   for key, v in r.items()} for r in rounds]

        # every emitted token: the greedy rule on its round's verify rows
        want = {r.rid: [r.generated[0]] for r in reqs}
        for r in rounds:
            for slot, rid in r["rids"].items():
                top_s, drafts = r["top"][slot], r["tokens"][slot, 1:]
                n = int(r["n_tok"][slot])
                j = 0
                while j < n - 1 and top_s[j] == drafts[j]:
                    j += 1
                want[rid] += [int(t) for t in top_s[:j + 1]]
        for req in reqs:
            assert req.generated == want[req.rid][:req.max_new_tokens], \
                f"request {req.rid}: not the greedy rule on its verify rows"

        # round check_round: the replay against the eager step and the
        # plain versions, on clones of its block and cache
        def routes(fn):
            """fn()'s output and each layer's (top-k ids, kept) per row."""
            seen, route = [], PMoE._route

            def recording(p, xg, mc):
                out = route(p, xg, mc)
                seen.append((out[3].reshape(-1, mc.top_k).clone(),
                             out[5].reshape(-1, mc.top_k).clone()))
                return out
            PMoE._route = recording
            try:
                return fn(), seen
            finally:
                PMoE._route = route

        def eager():
            d = []
            out = M.verify_step(cfg, eng.params, *saved["args"],
                                saved["cache"], drops=d)
            return out[0], torch.stack(d).sum(0, dtype=torch.int32)

        def plain():
            on_card = ops._on_card
            ops._on_card = lambda t: False
            try:
                return M.verify_step(cfg, eng.params, *saved["args"],
                                     saved["plain_cache"])[0]
            finally:
                ops._on_card = on_card
        logits, drops = saved["logits"], saved["drops"]
        (want_logits, want_drops), seen = routes(eager)
        assert torch.equal(logits, want_logits) and torch.equal(
            drops, want_drops), \
            "a replayed verify step differs from the eager step"
        got_plain, seen_plain = routes(plain)
        same = torch.ones(logits.shape[:2], dtype=torch.bool,
                          device=logits.device).reshape(-1)
        for (ti, kp), (pti, pkp) in zip(seen, seen_plain):
            same &= (ti == pti).all(-1) & (kp == pkp).all(-1)
        same = same.reshape(logits.shape[:2])
        real = torch.arange(k + 1, device=logits.device)[None] \
            < saved["args"][2][:, None]
        g, w = logits[..., :cfg.vocab], got_plain[..., :cfg.vocab]
        rel = (g - w).norm(dim=-1) / w.norm(dim=-1)
        held = real & same
        checked = dict(rows=int(real.sum()), held=int(held.sum()),
                       rel=float(rel[held].max()) if held.any() else 0.0,
                       drops=int(drops[real].sum()))
        assert checked["rel"] <= 2 ** -4, checked
        del saved, logits, drops, want_logits, want_drops, got_plain

        fracs = [(sum(int(r["drops"][i, :n].sum())
                      for i, n in enumerate(r["n_tok"]))
                  / max(int(r["n_tok"].sum()) * top * L, 1),
                  int(r["drops"].sum()) / (r["drops"].size * top * L))
                 for r in rounds]
        print(f"      {cfg.name} spec: {n_rounds} rounds, acceptance "
              f"{rep['spec_acceptance_rate']:.3f} ({rep['spec_accepted']}/"
              f"{rep['spec_proposed']}), tokens/slot-step "
              f"{rep['tokens_per_step']:.2f}; round p50 "
              f"{rep['decode_step_p50_s'] * 1e3:.2f} ms p99 "
              f"{rep['decode_step_p99_s'] * 1e3:.2f} (the decode step's p50 "
              f"{self.moe_p50[next(iter(self.moe_p50))] * 1e3:.2f} ms); "
              f"draft {rep['draft_time_s'] * 1e3:.0f} ms of "
              f"{sum(eng._step_times) * 1e3:.0f} ms of rounds")
        print(f"      dropped fraction a round (real rows / all rows): "
              + ", ".join(f"{a:.3f}/{b:.3f}" for a, b in fracs)
              + f"; rounds dropping {rep['verify_rounds_dropping']} of "
              f"{n_rounds}; real assignments dropped {rep['verify_dropped']} "
              f"({rep['verify_dropped_frac']:.4f})")
        print(f"      launches over the run {_nonzero(launches)}; "
              f"flash_decode_rows {L} a round (exact)")
        print(f"      every request's tokens, round by round: the greedy rule "
              f"on that round's verify rows ({len(reqs)} streams, "
              f"{n_rounds} rounds)")
        print(f"      round {check_round}: the replay equals an eager "
              f"verify_step on a clone, logits and drops bit for bit "
              f"({checked['drops']} real assignments dropped); the plain "
              f"versions: {checked['held']} of {checked['rows']} real rows "
              f"routed alike, each within {checked['rel']:.2e} of its "
              f"norm (bound 2^-4)")
        clean = [i for i, r in enumerate(reqs) if r.verify_dropped == 0]
        for i in clean:
            assert reqs[i].generated == streams[i], \
                f"request {i} dropped nothing but left the plain stream"
        print(f"      the {len(clean)} requests whose real rows dropped "
              f"nothing ({clean}) keep the dense run's streams; "
              f"{sum(r.generated == streams[i] for i, r in enumerate(reqs))} "
              f"of {len(reqs)} streams equal it in all")
        del eng
        out = {"speculative": launches}
        # one slot at k = 3: 4 rows a round, within the capacity of 4, so
        # no round can drop and the streams must be the dense run's; the
        # draft's cache has the target's length, so its prefill writes the
        # target's bits and a self-draft proposes the target's tokens
        assert PMoE._capacity(cfg.moe, 4) >= 4
        for layout, kw in (("dense", {}), ("paged", dict(
                page_size=16, kv_pool_pages=2 * max_len // 16))):
            # a pool of two slots' pages: admission reserves the write
            # range's pages beside the prompt's
            one = ServingEngine(cfg, params, max_slots=1, max_len=max_len,
                                device=self.dev, kv_layout=layout,
                                draft=(cfg, params), spec_k=3, **kw)
            solo = [one.submit(it.prompt, it.gen) for it in work[:2]]
            ops.reset_launch_counts()
            rep1 = one.run()
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            rows = "flash_decode_rows" if layout == "dense" \
                else "flash_decode_paged_rows"
            n1 = rep1["spec_rounds"]
            assert counts[rows] == L * n1, (counts, n1)
            assert rep1["verify_rounds_dropping"] == 0, \
                "a round of 4 rows dropped an assignment"
            assert [r.generated for r in solo] == streams[:2], \
                f"1-slot {layout} spec streams != the dense run's"
            assert rep1["spec_acceptance_rate"] == 1.0, rep1
            print(f"      1 slot, k=3, {layout} (4 rows a round, capacity "
                  f"4: no round can drop): {n1} rounds drop nothing, "
                  f"acceptance 1.000 ({rep1['spec_accepted']}/"
                  f"{rep1['spec_proposed']}), the {len(solo)} streams equal "
                  f"the dense run's; {rows} {counts[rows] // n1} a round "
                  f"(exact); round p50 "
                  f"{rep1['decode_step_p50_s'] * 1e3:.2f} ms")
            out[f"speculative 1 slot {layout}"] = counts
            del one
        return out

    def _moe_long(self, cfg, params, prompt_len=4608, gen=32):
        """One request of `prompt_len` tokens and `gen` new ones on a
        4-slot engine, past the window: its admission prefills the whole
        prompt (a 4608 bucket: 18 groups of 256 tokens, 80 slots an
        expert a group) and its decode attends the last `window` keys;
        exact launch counts, and its stream equal to an eager prefill and
        batch-1 decode steps (`_alone`)."""
        torch = self.torch
        import numpy as np
        from repro_torch.kernels import ops
        from repro_torch.serving import ServingEngine
        assert prompt_len > cfg.window, (prompt_len, cfg.window)
        prompt = np.random.default_rng(5).integers(
            0, cfg.vocab, prompt_len).astype(np.int32)
        eng = ServingEngine(cfg, params, max_slots=4,
                            max_len=prompt_len + gen, device=self.dev)
        torch.cuda.reset_peak_memory_stats()
        req = eng.submit(prompt, gen)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        L = cfg.n_layers
        runs = eng.decode_steps + 1 + prompt_len % 8
        want = _no_launches(**{k: n * runs for k, n in
                               self._moe_per_step(cfg).items()},
                            flash_decode=L * (runs - 1))
        assert launches == want, (launches, want)
        assert len(req.generated) == gen
        assert req.generated == self._alone(eng, prompt, gen), \
            "the long request's stream != its eager prefill and decode"
        print(f"      {cfg.name}: one request of {prompt_len} prompt tokens "
              f"and {gen} new (positions up to {prompt_len + gen - 1}, past "
              f"the {cfg.window}-token window), max_len {eng.max_len}: "
              f"launches {_nonzero(launches)} (exact); ttft "
              f"{req.ttft * 1e3:.0f} ms, {wall:.2f} s in all, "
              f"max_memory_allocated {peak / 2 ** 30:.3f} GiB; its stream "
              f"equals an eager prefill and batch-1 decode, token for token")
        del eng

    def _moe_vs_cpu(self, name, length=300, steps=4, tol=1e-4):
        """`name` at its reduced widths and depth 2 (4 experts, groups of
        32; mixtral's window 32), f32: a prefill of a `length`-token
        prompt and `steps` decode steps on the card (the CUDA kernels) and
        on the CPU (their plain versions) from the same weights: every
        layer's routing (expert ids and kept assignments) equal, logits and
        the KV cache within rtol 1e-4, atol 1e-4 x the largest |value|."""
        torch = self.torch
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.core.tree import leaves, tree_map
        from repro_torch.models import model as M
        from repro_torch.models import moe as MoE
        cfg = dataclasses.replace(get_config(name, reduced=True),
                                  dtype="float32")
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(0, cfg.vocab, (1, length + steps),
                             generator=torch.Generator().manual_seed(1))
        a = cfg.attn_chunk
        max_len = -(-(length + steps) // a) * a
        route, out = MoE._route, []
        try:
            for dev in (self.dev, torch.device("cpu")):
                seen = []

                def record(*args, **kw):
                    r = route(*args, **kw)
                    seen.append((r[3].cpu(), r[5].cpu()))
                    return r
                MoE._route = record
                p = tree_map(lambda x: x.to(dev), params)
                cache = M.init_cache(cfg, 1, max_len, dev)
                logits, cache = M.prefill(cfg, p, {"tokens": toks[:, :length]
                                                   .to(dev)}, cache)
                logs = [logits]
                for i in range(steps):
                    logits, cache = M.decode_step(
                        cfg, p, toks[:, length + i:length + i + 1].to(dev),
                        length + i, cache)
                    logs.append(logits)
                out.append(([t.cpu() for t in logs]
                            + [v.cpu() for v in leaves(cache)], seen))
        finally:
            MoE._route = route
        (card, card_routes), (cpu, cpu_routes) = out
        assert len(card_routes) == len(cpu_routes) == 2 * (1 + steps)
        dropped = 0
        for (ti, kp), (tj, kq) in zip(card_routes, cpu_routes):
            assert torch.equal(ti, tj) and torch.equal(kp, kq), name
            dropped += int((~kq).sum())
        worst = 0.0
        for x, y in zip(card, cpu):
            assert torch.isfinite(x).all(), "non-finite output on the card"
            scale = y.abs().max().item()
            torch.testing.assert_close(x, y, rtol=tol, atol=tol * scale)
            worst = max(worst, ((x - y).abs().max() / scale).item())
        print(f"      {cfg.name}, depth 2, f32: a {length}-token prefill and "
              f"{steps} decode steps on the card against the CPU: every "
              f"layer's expert ids and kept assignments equal ({dropped} "
              f"assignments dropped), logits and KV cache within rtol "
              f"{tol:g}; max |diff| / max |value| {worst:.2e}")

    # -- 13. whisper-tiny (encdec) at full width ----------------------------
    def _whisper_params(self, cfg):
        """whisper-tiny's random params drawn on the card from a CUDA
        generator of seed 0 and held in bf16, then every leaf init_params
        starts at zeros (the biases of every projection and MLP, each
        norm's bias) drawn from one of seed 1 (a bias of zeros passes any
        check)."""
        torch = self.torch
        import dataclasses
        from repro_torch.core.tree import tree_map
        from repro_torch.models import model as M
        params = M.init_params(
            dataclasses.replace(cfg, param_dtype="bfloat16"),
            torch.Generator(device=self.dev).manual_seed(0), self.dev)
        gen = torch.Generator(device=self.dev).manual_seed(1)
        return tree_map(lambda t: t if t.any() else (torch.randn(
            t.shape, generator=gen, device=self.dev) * 0.1).to(t.dtype),
            params)

    @staticmethod
    def _encdec_want(eng, prompts, int8=False):
        """Launch counts of a whisper run. A one-token step (decode, or an
        admission's remainder token) runs 8 GEMMs a decoder layer (self
        Q, K, V, O; cross Q, O; w_in with bias_gelu, w_out with bias),
        self and cross decode attention, and the tied logits; an admission
        prefill runs the encoder (6 GEMMs and the non-causal flash forward
        a layer), the cross K/V projections (2 a decoder layer), the
        decoder (8 GEMMs and the cross flash forward a layer; its causal
        self-attention into the cache is the chunked path's PyTorch) and
        the logits. With int8 weights every GEMM but the tied logits takes
        matmul_q."""
        cfg = eng.cfg
        L, E, n = cfg.n_layers, cfg.n_enc_layers, len(prompts)
        one = eng.decode_steps + sum(len(p) % 8 for p in prompts
                                     if len(p) >= 8)
        step, pre = 8 * L, 6 * E + 10 * L
        want = _no_launches(flash_decode=2 * L * one,
                            flash_attention=(E + L) * n)
        if int8:
            want.update(matmul_q=step * one + pre * n, matmul=one + n)
        else:
            want.update(matmul=(step + 1) * one + (pre + 1) * n)
        return want

    def _encdec_admission(self, eng, prompt, frames, int8, reps=5):
        """The launches of one eager admission prefill of `prompt` with
        `frames`, by part: the encoder, the cross K/V projections, and the
        whole prefill (the decoder's part the difference); then the median
        host-clock time of `reps` encoder runs and of `reps` whole
        prefills, each ending in a sync."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.models import attention as A
        from repro_torch.models import model as M
        from repro_torch.models import transformer as T
        cfg, params = eng.cfg, eng.params
        L, E = cfg.n_layers, cfg.n_enc_layers
        g = "matmul_q" if int8 else "matmul"
        f = torch.as_tensor(frames, device=self.dev)[None]
        toks = torch.as_tensor(prompt, dtype=torch.long, device=self.dev)
        ops.reset_launch_counts()
        enc_out = M._run_encoder(cfg, params, f)
        enc = _nonzero(ops.launch_counts())
        ops.reset_launch_counts()
        for lp in T._unstack(params["dec_layers"]["cross_attn"], L):
            A.project_cross_kv(lp, enc_out, cfg)
        cross = _nonzero(ops.launch_counts())
        ops.reset_launch_counts()
        cache = M.init_cache(cfg, 1, eng.max_len, self.dev)
        M.prefill(cfg, params, {"tokens": toks[None], "enc_frames": f}, cache)
        torch.cuda.synchronize()
        total = _nonzero(ops.launch_counts())
        want_enc = {g: 6 * E, "flash_attention": E}
        want_total = {"flash_attention": E + L, g: 6 * E + 10 * L}
        want_total["matmul"] = want_total.get("matmul", 0) + 1
        assert (enc, cross, total) == (want_enc, {g: 2 * L}, want_total), \
            (enc, cross, total)
        dec = {k: v - enc.get(k, 0) - cross.get(k, 0)
               for k, v in total.items()}
        print(f"      an admission's launches (eager, exact): encoder {enc}, "
              f"cross K/V {cross}, decoder and logits {_nonzero(dec)}")

        def timed(fn):
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)
        enc_ms = timed(lambda: M._run_encoder(cfg, params, f))
        pre_ms = timed(lambda: M.prefill(
            cfg, params, {"tokens": toks[None], "enc_frames": f}, cache))
        print(f"      an eager admission prefill of {len(prompt)} tokens: "
              f"{pre_ms:.2f} ms on the host clock (median of {reps}, synced), "
              f"of which the encoder alone {enc_ms:.2f} ms")

    def phase_encdec(self):
        """whisper-tiny at full width and depth (4 encoder and 4 decoder
        layers, d 384, 6 heads of 64, 1500 frames), random weights drawn
        on the card in bf16 with random biases: 8 requests on 4 slots,
        each with its own 1500 x 384 frames, prompts of 8-192 tokens and 48
        generated (within Whisper's 448-token decoder context), in bf16
        and with int8 weights. Each run: an admission's launches by part,
        exact launch counts, each stream equal to its request alone (a
        1-slot engine), a replay against the eager step and a trace,
        decode p50 and p99, time to first token, peak memory and capture
        time; the memory back after each engine (to what it was with the
        params drawn) and after the params. Then a prefill and 4
        decode steps at full width in f32 on the card against the CPU."""
        torch = self.torch
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.core.tree import leaves
        from repro_torch.serving import ServingEngine, synthetic_trace
        cfg = get_config("whisper-tiny")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = self._whisper_params(cfg)
        n_params = sum(t.numel() for t in leaves(params))
        gen, trace_len = 48, 160
        work = synthetic_trace(cfg, 8, rng=np.random.default_rng(0),
                               len_range=(8, 192), gen=gen)
        prompts = [it.prompt for it in work]
        frames = [it.enc_frames for it in work]
        longest = max(max(len(p) for p in prompts) + gen, trace_len + 6)
        max_len = -(-longest // 16) * 16
        torch.cuda.synchronize()
        with_params = torch.cuda.memory_allocated()
        print(f"[13/19] {cfg.name}: {cfg.n_enc_layers} encoder and "
              f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, heads "
              f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.resolved_head_dim}, d_ff "
              f"{cfg.d_ff} (gelu), layernorm, sinusoid positions, "
              f"{cfg.enc_ctx} encoder frames, vocab {cfg.vocab}->"
              f"{cfg.padded_vocab} (tied); {n_params / 1e6:.3f} M params "
              f"drawn on the card (seed 0, biases seed 1), held in bf16, in "
              f"{time.perf_counter() - t0:.1f} s; {len(work)} requests, "
              f"prompts {[len(p) for p in prompts]}, gen {gen}, 4 slots, "
              f"max_len {max_len}")
        self.encdec_launches = {}
        p50 = None
        for int8 in (False, True):
            what = "int8 weights" if int8 else "bf16"
            eng = ServingEngine(cfg, params, max_slots=4, max_len=max_len,
                                device=self.dev,
                                quant="int8" if int8 else "off")
            shape = tuple(eng.cache["cross"]["k"].shape)
            print(f"      {what}: the cross cache {shape} x 2, "
                  f"{4 * math.prod(shape) / 2 ** 20:.2f} MiB of bf16, read "
                  f"in place by the captured steps")
            _print_capture(eng)
            self._encdec_admission(eng, prompts[0], frames[0], int8)
            launches, report = self._serve_checked(
                eng, prompts, gen,
                lambda e, i=int8: self._encdec_want(e, prompts, i), what,
                p50, frames=frames)
            self.encdec_launches[cfg.name + (" int8" if int8 else "")] = \
                launches
            p50 = p50 or report["decode_step_p50_s"]
            self._trace(eng, report["decode_step_p50_s"], n_steps=4,
                        expect=("matmul_q" if int8 else "matmul",
                                "flash_decode"), prompt_len=trace_len,
                        roofline=not int8)
            del eng
            self._memory_back(with_params, what)
        del params
        self._memory_back(base, cfg.name)
        self._encdec_vs_cpu()

    def _encdec_vs_cpu(self, length=100, steps=4, tol=1e-4):
        """whisper-tiny at full width and depth in f32, random biases: a
        prefill of two 100-token prompts with their frames, then 4 decode
        steps at a per-slot position vector with slot 1 idle, on the card
        (the CUDA kernels) and on the CPU (their plain versions) from the
        same weights: logits (the idle row's too: zeros from its attention
        on both) and every cache leaf within rtol 1e-4, atol 1e-4 x the
        largest |value| (f32 sums in another order)."""
        torch = self.torch
        import dataclasses
        from repro_torch.configs import get_config
        from repro_torch.core.tree import leaves, tree_map
        from repro_torch.models import model as M
        cfg = dataclasses.replace(get_config("whisper-tiny"), dtype="float32")
        g = torch.Generator().manual_seed(1)
        params = tree_map(lambda t: t if t.any() else torch.randn(
            t.shape, generator=g) * 0.1, M.init_params(
                cfg, torch.Generator().manual_seed(0), "cpu"))
        toks = torch.randint(0, cfg.vocab, (2, length + steps), generator=g)
        frames = torch.randn((2, cfg.enc_ctx, cfg.d_model), generator=g)
        # a KV length past attn_chunk is a whole number of chunks
        a = cfg.attn_chunk
        max_len = length + steps if length + steps <= a \
            else -(-(length + steps) // a) * a
        out = []
        for dev in (self.dev, torch.device("cpu")):
            p = tree_map(lambda x: x.to(dev), params)
            cache = M.init_cache(cfg, 2, max_len, dev)
            t0 = time.perf_counter()
            logits, cache = M.prefill(
                cfg, p, {"tokens": toks[:, :length].to(dev),
                         "enc_frames": frames.to(dev)}, cache)
            logs = [logits]
            for i in range(steps):
                pos = torch.tensor([length + i, -1], dtype=torch.int32,
                                   device=dev)
                logits, cache = M.decode_step(
                    cfg, p, toks[:, length + i:length + i + 1].to(dev), pos,
                    cache)
                logs.append(logits)
            got = [t.cpu() for t in logs] + [v.cpu() for v in leaves(cache)]
            out.append((got, time.perf_counter() - t0))
        (card, tc), (cpu, tp) = out
        worst = 0.0
        for x, y in zip(card, cpu):
            assert torch.isfinite(x).all(), "non-finite output on the card"
            scale = y.abs().max().item()
            torch.testing.assert_close(x, y, rtol=tol, atol=tol * scale)
            worst = max(worst, ((x - y).abs().max() / scale).item())
        print(f"      full width and depth, f32, two {length}-token prompts "
              f"with their frames and {steps} decode steps (slot 1 idle): "
              f"card ({tc * 1e3:.0f} ms) against CPU ({tp * 1e3:.0f} ms): "
              f"logits, self and cross caches within rtol {tol:g}; max "
              f"|diff| / max |value| {worst:.2e}")

    # -- 14. training the encdec, vlm and moe families at full width ---
    def phase_train_families(self, steps=16, batch=4):
        """whisper-tiny (full depth, 4 x 448 tokens with 4 x 1500 x 384 f32
        frames a step), qwen2-vl-2b (full depth, 4 x 512 tokens, a 16 x 16
        image span a row) and mixtral-8x22b (full width, 1 of its 56
        layers, 4 x 512 tokens): `steps` donated AdamW steps each (f32
        params, bf16 activations, remat "full", lr 1e-3 with 2 warmup
        steps and a cosine over `steps`, clip 1.0), held to exact launch
        counts a step, `loss_falls`, speed, memory and a trace of a step
        (`_train_run`). Then whisper's step in f32 at full size (one row:
        448 tokens over 1500 frames) and qwen2-vl-2b's at depth 2 (one
        row of 320 tokens with its image) against the CPU (rtol 1e-4);
        mixtral's step 0 with remat "none" (its loss bit for bit) and
        through the plain versions on the card (within 1e-3). Every
        model's weights are drawn on the card (a CUDA generator of seed
        0)."""
        import dataclasses
        from repro_torch.configs import get_config
        print(f"[14/19] training the encdec, vlm and moe families at full "
              f"width: {steps} donated AdamW steps each at batch {batch}")
        self.family_train_launches = {}
        wh = get_config("whisper-tiny")
        run = self._train_family(wh, steps, batch, 448,
                                 self._encdec_train_want(wh))
        del run
        self._train_step_vs_cpu(dataclasses.replace(wh, dtype="float32"),
                                1, 448, 1e-4, "full size")
        vl = get_config("qwen2-vl-2b")
        L = vl.n_layers
        run = self._train_family(
            vl, steps, batch, 512, _no_launches(
                matmul=(5 * L + 1) * 3 + 6 * L + 5 * L, gated_matmul=2 * L,
                flash_attention=2 * L, flash_attention_bwd=L))
        del run
        self._train_step_vs_cpu(dataclasses.replace(vl, n_layers=2,
                                                    dtype="float32"),
                                1, 320, 1e-4, "depth 2")
        mx = dataclasses.replace(get_config("mixtral-8x22b"), n_layers=1)
        L = mx.n_layers
        run = self._train_family(
            mx, steps, batch, 512, _no_launches(
                matmul=(5 * L + 1) * 3 + 5 * L, gated_matmul_batched=2 * L,
                matmul_batched=10 * L, flash_attention=2 * L,
                flash_attention_bwd=L), repeats=True)
        del run

    def _train_family(self, cfg, steps, batch, seq, want, repeats=False):
        """`_train_run` of cfg's donated steps from seed 0's weights on the
        card's generator, held to `want` and `loss_falls`, then a traced
        step; with `repeats`, step 0 again with remat "none" and through
        the plain versions on the card. The run's launch counts go to
        `family_train_launches`."""
        torch = self.torch
        from repro_torch.models import model as M
        from repro_torch.optim.adamw import AdamW, cosine_schedule
        from repro_torch.training import train_loop as TL
        opt = AdamW(lr=cosine_schedule(1e-3, 2, steps), clip_norm=1.0)

        def make_state():
            params = M.init_params(
                cfg, torch.Generator(device=self.dev).manual_seed(0),
                self.dev)
            return TL.TrainState(params, opt.init(params))
        extra = (f", {cfg.moe.n_experts} experts of d_ff {cfg.d_ff} top-"
                 f"{cfg.moe.top_k}" if cfg.moe else "") + (
            f", {cfg.n_enc_layers} encoder layers over {cfg.enc_ctx} frames"
            if cfg.family == "encdec" else "") + (
            ", a 16 x 16 image span a row" if cfg.family == "vlm" else "")
        print(f"      {cfg.name}: {cfg.n_layers} layer"
              f"{'s' * (cfg.n_layers > 1)}, d_model "
              f"{cfg.d_model}{extra}; bf16 activations, remat {cfg.remat}; "
              f"batch {batch} x {seq}")
        batches = self._train_batches(cfg, steps + 1, batch, seq)
        run = self._train_run(TL.make_train_step(cfg, opt, donate=True),
                              make_state, batches[:steps], want,
                              falls=loss_falls)
        self.family_train_launches[f"{cfg.name} training"] = run["launches"]
        expect = tuple(k for k, v in want.items() if v)
        self._trace_train_step(run["step_fn"], run.pop("state"),
                               batches[steps], expect)
        if repeats:
            self._remat_none(cfg, opt, make_state, batches[:2], run,
                             donate=True)
            self._train_plain(cfg, opt, make_state, batches, run, 1,
                              donate=True)
        return run

    @staticmethod
    def _encdec_train_want(cfg):
        """Launch counts of an encdec train step under remat "full". An
        encoder block runs 6 GEMMs (Q, K, V, O; w_in with bias_gelu, w_out
        with bias) and a non-causal attention forward; a decoder block 10
        (self Q, K, V, O; cross Q, O and the K, V of the encoder's output;
        w_in, w_out), a causal and a cross attention forward. Each block's
        forward runs again in its recompute. The backward: 2 GEMMs (dx,
        dw) for each and one more for w_in (its gelu's z recomputed), an
        attention backward for each forward; the tied logits 1 GEMM and 2
        in the backward."""
        e, d = cfg.n_enc_layers, cfg.n_layers
        return _no_launches(matmul=2 * (6 * e + 10 * d) + 13 * e + 21 * d + 3,
                            flash_attention=2 * (e + 2 * d),
                            flash_attention_bwd=e + 2 * d)

    # -- 15. the paper's experiment ---------------------------------------
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
        print(f"[15/19] the paper's experiment at n={n} (Table 2, Figs 8-9)")
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

    # -- 16. tuned tiles at full width -------------------------------------
    def phase_tuning(self, gen=16):
        """The autotuner at qwen3-0.6b's full width: `warm_start(...,
        autotune=True)` into a temporary cache for the decode step's
        GEMM shapes (4 slots), the admission prefill's (batch 1 over the 4
        prompts' buckets and the one-token remainder steps) and
        training's (phase 7's 4 x 512 with its backward), each shape in
        the layouts the step runs it in, a line a shape (the static
        instance and the winner, timed in the same turns); the sweep's
        seconds, a second warm_start that hits every shape; every
        candidate of every tuned shape against the static plan's output,
        bit for bit, in each of its layouts. Then a second cache whose
        winners are forced off the static plans (a timer that favours
        each space's last instance). Served under the static plans, the
        sweep's winners (what `--backend tuned` sets) and the forced ones
        (4 slots, 4 of phase 4's prompts, 16 tokens each): the same
        streams token for token, exact launch counts, the decode p50s,
        and the count of distinct GEMM shapes each run served off its
        static plan (the forced run must move prefill and decode shapes
        both). One train step from phase 7's state and first batch under
        each cache: phase 7's step 0 loss and grad norm bit for bit, its
        launches, the shapes served off the static plan (the forced step
        must move some)."""
        torch = self.torch
        import os
        import tempfile
        from repro_torch import tuning
        from repro_torch.configs import get_config
        from repro_torch.core.tree import tree_map
        from repro_torch.kernels import ops
        from repro_torch.serving import ServingEngine
        from repro_torch.training import train_loop as TL
        cfg = get_config("qwen3-0.6b")
        work = [it._replace(gen=gen) for it in self.work[:4]]
        prompts = [it.prompt for it in work]
        max_len = max(len(p) for p in prompts) + gen
        buckets = sorted({len(p) - len(p) % 8 or len(p) for p in prompts}
                         | {1})
        train = self.train_step0
        batch, seq = train["batch"]["tokens"].shape
        print(f"[16/19] tuned tiles at full width ({cfg.name}): decode at 4 "
              f"slots, prefill buckets {buckets}, training {batch} x {seq} "
              f"with its backward; each shape in its layouts")
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            cache = tuning.TuningCache(os.path.join(tmp, "tuning.json"))
            shapes = (dict(batch=4, seq=1, decode_len=max_len),
                      dict(batch=1, seq=buckets),
                      dict(batch=batch, seq=seq, backward=True))
            t0 = time.perf_counter()
            reps = [tuning.warm_start(cfg, autotune=True, cache=cache,
                                      device=self.dev, **kw)
                    for kw in shapes]
            sweep_s = time.perf_counter() - t0
            results = [r for rep in reps for r in rep["results"]]
            for r in results:
                rest = ", ".join(f"{c.name} {t * 1e3:.4f}"
                                 for c, t in r.trials[1:])
                print(f"      {r.key:44s} {_layout_names(r.layouts):24s} "
                      f"static {r.baseline.name:10s} "
                      f"{r.baseline_s * 1e3:8.4f} ms  winner "
                      f"{r.best.name:10s} {r.best_s * 1e3:8.4f} ms  "
                      f"{r.speedup:.3f}x" + (f" (the others: {rest})"
                                             if rest else ""))
            saved = sum(r.baseline_s - r.best_s for r in results)
            print(f"      the sweep: {len(results)} shapes tuned in "
                  f"{sweep_s:.1f} s; "
                  f"{sum(r.best is not r.baseline for r in results)} "
                  f"winners are not the static plan; {saved * 1e3:.4f} ms "
                  f"saved over one call of each shape; "
                  f"{sum(len(rep['fixed']) for rep in reps)} attention "
                  f"shapes of one instance, not timed")
            t0 = time.perf_counter()
            again = [tuning.warm_start(cfg, cache=tuning.TuningCache(
                cache.path).load(), device=self.dev, **kw) for kw in shapes]
            assert all(not rep["misses"] and not rep["tuned"]
                       for rep in again), again
            n_hits = sum(len(rep["hits"]) for rep in again)
            print(f"      a second warm_start from the file: {n_hits} hits, "
                  f"0 misses in {time.perf_counter() - t0:.2f} s")
            self._tuned_candidates_bits(results)
            forced = tuning.TuningCache(os.path.join(tmp, "forced.json"))
            last = lambda fns: [1.0 - i / 1e3 for i in range(len(fns))]
            moved = sum(r.best is not r.baseline
                        for kw in shapes
                        for r in tuning.warm_start(
                            cfg, autotune=True, cache=forced,
                            device=self.dev, timer=last, **kw)["results"])
            print(f"      forced cache: {moved} of {len(forced)} shapes' "
                  f"winners are each space's last instance, not the static "
                  f"plan")
            caches = {"static": None, "tuned": cache, "forced": forced}
            runs = {}
            for what, c in caches.items():
                with _served_off_static() as off:
                    with tuning.tuned(c):
                        eng = ServingEngine(cfg, self._serve_params(cfg),
                                            max_slots=4, max_len=max_len,
                                            device=self.dev)
                    assert eng.tuned_cache is c and \
                        tuning.tuned_cache() is None
                    reqs, rep, launches = self._run_counted(eng, work)
                want = self._want_launches(eng, reqs, dict(
                    matmul=5 * cfg.n_layers + 1,
                    gated_matmul=cfg.n_layers))
                want["flash_decode"] += cfg.n_layers * eng.decode_steps
                want["flash_decode_paged"] = 0
                assert launches == want, (what, launches, want)
                runs[what] = ([list(r.generated) for r in reqs], rep,
                              launches, off)
                del eng
            streams = runs["static"][0]
            for what in ("tuned", "forced"):
                assert runs[what][0] == streams, (what, runs[what][0],
                                                  streams)
            assert not runs["static"][3]
            f_off = runs["forced"][3]
            assert any(m == 4 for _, _, m, _, _, _ in f_off) and \
                any(m > 4 for _, _, m, _, _, _ in f_off), f_off
            self.tuned_launches = runs["tuned"][2]
            print(f"      serve (4 slots, 4 requests, {gen} tokens) under the "
                  f"static plans, the sweep's winners and the forced ones: "
                  f"the same streams, token for token; launches "
                  f"{_nonzero(self.tuned_launches)} (exact, each run); GEMM "
                  f"shapes served off the static plan: "
                  + ", ".join(f"{what} {_off_counts(runs[what][3])}"
                              for what in ("tuned", "forced"))
                  + "; decode step p50 " + ", ".join(
                      f"{what} {runs[what][1]['decode_step_p50_s'] * 1e3:.2f}"
                      for what in caches) + " ms")
            opt = train["opt"]
            for what, c in (("tuned", cache), ("forced", forced)):
                params = tree_map(lambda t: t.to(self.dev, copy=True),
                                  train["host"])
                state = TL.TrainState(params, opt.init(params))
                step = TL.make_train_step(cfg, opt, donate=True)
                with _served_off_static() as off, tuning.tuned(c):
                    ops.reset_launch_counts()
                    t0 = time.perf_counter()
                    state, met = step(state, train["batch"])
                    loss, norm = float(met["loss"]), float(met["grad_norm"])
                    t = time.perf_counter() - t0
                    launches = ops.launch_counts()
                del state, params
                assert (loss, norm) == (train["loss"], train["norm"]), \
                    (what, loss, norm, train)
                assert launches == train["want"], (what, launches,
                                                   train["want"])
                assert what != "forced" or off, "no forced plan served"
                if what == "tuned":
                    self.tuned_train_launches = launches
                print(f"      a train step under the {what} plans: loss "
                      f"{loss:.6f} grad norm {norm:.6f}, phase 7's step 0 "
                      f"bit for bit; launches {_nonzero(launches)} (exact); "
                      f"GEMM shapes served off the static plan "
                      f"{_off_counts(off)}; {t * 1e3:.1f} ms (the first "
                      f"step of its state)")
        assert tuning.tuned_cache() is None

    def _tuned_candidates_bits(self, results):
        """Every candidate of each tuned GEMM shape (seeded operands, in
        each layout the shape was timed in) gives the static plan's
        output bit for bit."""
        torch = self.torch
        from repro_torch.core import precision
        from repro_torch.kernels import matmul as tmm
        gen = torch.Generator(device=self.dev).manual_seed(3)

        def randn(*shape, dtype=torch.bfloat16, scale=1.0):
            return (torch.randn(shape, generator=gen, device=self.dev)
                    * scale).to(dtype)
        n_runs = 0
        for r in results:
            m, n, k = (int(x) for x in r.key.split("|")[1].split("x"))
            ep = r.key.split("|")[4] if r.key.count("|") == 4 else "none"
            a = randn(m, k)
            e = randn(m, n) if ep == "residual" else \
                randn(n) if ep != "none" else None
            if r.op == "gated":
                wg, wu = (randn(k, n, scale=k ** -0.5) for _ in range(2))
                runs = [lambda p: tmm.gated_matmul_tiled(a, wg, wu, plan=p)]
            elif r.op == "matmul_q":
                wq, scale = precision.quantize_int8(
                    randn(k, n, dtype=torch.float32, scale=k ** -0.5))
                runs = [lambda p, out=out: tmm.matmul_q_tiled(
                    a, wq, scale.reshape(n), out_dtype=out, epilogue=ep,
                    epilogue_operand=e, plan=p)
                    for out in _out_dtypes(torch, r.layouts)]
            else:
                b = randn(k, n, scale=k ** -0.5)
                a_t, b_t = a.t().contiguous().t(), b.t().contiguous().t()
                runs = [lambda p, a=a_t if t_a else a, b=b_t if t_b else b,
                        out=out: tmm.matmul_tiled(
                            a, b, out_dtype=out, epilogue=ep,
                            epilogue_operand=e, plan=p)
                        for (t_a, t_b, _), out in zip(
                            r.layouts, _out_dtypes(torch, r.layouts))]
            for run in runs:
                want = run(r.baseline)
                for c, _ in r.trials[1:]:
                    assert torch.equal(run(c), want), (r.key, c.name)
                    n_runs += 1
                del want
        torch.cuda.synchronize()
        print(f"      every candidate of every tuned GEMM shape gives the "
              f"static plan's output bit for bit in each of its layouts "
              f"({n_runs} candidate calls against their static plans)")

    # -- 17. the roofline of a step ----------------------------------------
    def _count_step(self, what, cfg, cell, fn, ms, ms_what):
        """One eager run of fn(), counted (`roofline.counter.count()`),
        kept for phase 17 with its report (`analysis.build_report` for
        `cfg` at the ShapeCell `cell`), the kernel launches the run made,
        and `ms`, the time of the same step that an earlier phase measured
        (`ms_what` says which). Returns fn()'s result."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.roofline import analysis, counter
        torch.cuda.synchronize()
        # count() reads the run's peak without resetting the statistic:
        # this window is the count's alone
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        with counter.count() as costs:
            out = fn()
        seconds = time.perf_counter() - t0
        after = ops.launch_counts()
        self.rooflines.append(dict(
            what=what, cfg=cfg, cell=cell, costs=costs, ms=ms,
            ms_what=ms_what, seconds=seconds,
            launched={k: after[k] - before[k] for k in after
                      if after[k] != before[k]},
            report=analysis.build_report(cfg, cell, kind=cell.kind,
                                         costs=costs)))
        return out

    def _count_prefill(self, eng, prompt, n=5):
        """An admission prefill of `prompt` (its bucket, as `_admit` runs
        it) on `eng`'s weights into a copy of its batch-1 cache: the
        median of n eager runs on the host clock, then one counted."""
        torch = self.torch
        from repro_torch.configs.base import ShapeCell
        from repro_torch.models import model as M
        lb = len(prompt) - len(prompt) % eng.prefill_chunk or len(prompt)
        batch = {"tokens": torch.as_tensor(prompt[:lb], dtype=torch.long,
                                           device=self.dev)[None]}
        sub = _clone_tree(eng._sub)

        def prefill():
            return M.prefill(eng.cfg, eng.params, batch, sub)
        times = []
        for _ in range(n + 1):
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        self._count_step(
            f"{eng.cfg.name} admission prefill, {lb} tokens", eng.cfg,
            ShapeCell(f"prefill_{lb}", "prefill", lb, 1), prefill,
            statistics.median(times[1:]) * 1e3,
            f"median of {n} eager prefills after one (host clock)")

    def phase_roofline(self, band=(1.25, 1.45),
                       whole=(("qwen3-0.6b", 1.233161890766593),)):
        """The counted steps' rooflines (`_count_step`), each beside the
        time its phase measured: the share of the roofline (the larger of
        the compute and memory terms over that time) and mfu (the model's
        FLOPs over that time over the bf16 peak). Checks: each count's
        charged calls by kernel are the launches its run made; remat
        "full" counts `band` x the FLOPs of "none" over what it
        recomputes, the blocks: the step less the logits' GEMMs (the
        counted `matmul` charges with the padded vocabulary among their
        dims: the forward, dx and dw), which no remat covers. Over the
        whole step the ratio must be `whole`'s for the model, what a count
        of the same step on the CPU gives (qwen3-0.6b at 4 x 512 under a
        FakeTensorMode: the count depends on shapes alone)."""
        whole = dict(whole)
        peak = self.chip.peak_flops_bf16
        total = sum(r["seconds"] for r in self.rooflines)
        print(f"[17/19] the roofline of a step: {len(self.rooflines)} steps, "
              f"each one eager run counted by roofline.counter (the graphs' "
              f"replays are not counted), {total:.1f} s of counting in the "
              f"phases that ran them; terms at {self.chip.name}'s "
              f"{peak / 1e12:g} TFLOP/s bf16 and "
              f"{self.chip.hbm_bw / 1e12:g} TB/s")
        faults = []
        for r in self.rooflines:
            rep, costs, t = r["report"], r["costs"], r["ms"] / 1e3
            top = "; ".join(f"{b / 2 ** 20:.1f} MiB {d}"
                            for b, d, _ in costs.top_charges(5))
            peak_gib = "not read" if costs.peak_bytes is None \
                else f"{costs.peak_bytes / 2 ** 30:.3f} GiB"
            print(f"      {r['what']}: {costs.flops / 1e12:.4f} TFLOP, "
                  f"{costs.hbm_bytes / 2 ** 30:.4f} GiB; t_compute "
                  f"{rep.t_compute * 1e3:.4f} ms t_memory "
                  f"{rep.t_memory * 1e3:.4f} ms bound {rep.bound}; useful "
                  f"{rep.useful_ratio:.4f} mfu_roofline "
                  f"{rep.mfu_roofline:.4f}; measured {r['ms']:.3f} ms "
                  f"({r['ms_what']}): share of the roofline "
                  f"{max(rep.t_compute, rep.t_memory) / t:.4f}, mfu "
                  f"{rep.model_flops_total / t / peak:.4f}; "
                  f"max_memory_allocated {peak_gib}; counted in "
                  f"{r['seconds']:.2f} s")
            print(f"        calls {costs.calls}; top 5: {top}")
            if costs.calls != r["launched"]:
                faults.append((r["what"], costs.calls, r["launched"]))
        print(f"      each kernel launch of the {len(self.rooflines)} counted "
              f"runs charged exactly once: "
              f"{'yes' if not faults else f'NO: {faults}'}")
        train = {}
        for r in self.rooflines:
            if r["cell"].kind == "train":
                train.setdefault(r["cfg"].name, {})[r["cfg"].remat] = r

        def head(costs, vocab):
            return sum(f for _, d, f in costs.charges
                       if d.split()[0] == "matmul"
                       and str(vocab) in d.split()[1].split("x"))
        bands, wholes = {}, {}
        for name, by in train.items():
            if not {"full", "none"} <= by.keys():
                continue
            full, none = by["full"]["costs"], by["none"]["costs"]
            vocab = by["full"]["cfg"].padded_vocab
            hf, hn = head(full, vocab), head(none, vocab)
            wholes[name] = full.flops / none.flops
            bands[name] = (full.flops - hf) / (none.flops - hn)
            print(f"      {name} remat: \"full\" counts "
                  f"{wholes[name]!r}x the FLOPs of \"none\" over the whole "
                  f"step (the CPU's count: {whole.get(name)!r}x), "
                  f"{bands[name]!r}x "
                  f"over the blocks it recomputes (less the logits' counted "
                  f"{hf / 1e12:.4f} / {hn / 1e12:.4f} TFLOP); band {band}")
        assert not faults, faults
        assert bands and all(band[0] < x < band[1] for x in bands.values()), \
            (bands, band)
        assert wholes.keys() == whole.keys() and all(
            abs(x - whole[name]) <= 1e-9 for name, x in wholes.items()), \
            (wholes, whole)

    # -- 18. distributed ---------------------------------------------------
    def phase_distributed(self, n=4096, p=4, train_steps=4, batch=4,
                          seq=512):
        """(a)-(d) of the module's docstring."""
        torch = self.torch
        import torch.distributed as dist
        from repro_torch.core import distributed as D
        from repro_torch.core import gemm
        from repro_torch.kernels import ops
        from repro_torch.launch import mesh as mesh_lib
        print(f"[18/19] distributed: one card, so a world of 1 and the "
              f"shards of a {p}-rank schedule on it; link times are a model "
              f"({self.chip.name}: {self.chip.nvlink_links} NVLink links of "
              f"{self.chip.nvlink_bw / 1e9:g} GB/s a direction, the data "
              f"sheet's)")
        gen = torch.Generator(device=self.dev).manual_seed(18)
        tol = {torch.bfloat16: 2 ** -7, torch.float32: 1e-4}
        # (a) the schedules in a NCCL world of 1: the chokepoint's bits
        with mesh_lib.host_mesh(1, self.dev) as mesh:
            assert dist.get_backend() == mesh_lib.backend_for(self.dev) \
                and tuple(mesh.shape) == (1, 1)
            for dtype in (torch.bfloat16, torch.float32):
                a = torch.randn(n, n, generator=gen, device=self.dev,
                                dtype=dtype)
                b = torch.randn(n, n, generator=gen, device=self.dev,
                                dtype=dtype)
                whole = gemm.matmul(a, b)
                for s in ("ring", "column", "row"):
                    ops.reset_launch_counts()
                    got = D.sharded_matmul(a, b, mesh, schedule=s)
                    torch.cuda.synchronize()
                    launched = _nonzero(ops.launch_counts())
                    assert launched == {"matmul": 1}, (s, launched)
                    assert torch.equal(got, whole), (s, dtype)
                print(f"      (a) world of 1 ({dist.get_backend()}): ring, "
                      f"column and row at "
                      f"{n}^2 {str(dtype)[6:]} each equal the chokepoint's "
                      f"product bit for bit, one matmul launch each")
        # (b) a p-rank schedule's local GEMMs, on the one card
        kb = n // p
        for dtype in (torch.bfloat16, torch.float32):
            a = torch.randn(n, n, generator=gen, device=self.dev, dtype=dtype)
            b = torch.randn(n, n, generator=gen, device=self.dev, dtype=dtype)
            whole = gemm.matmul(a, b)
            scale = whole.float().abs().max().item()
            item = a.element_size()
            blk = [slice(r * kb, (r + 1) * kb) for r in range(p)]
            ops.reset_launch_counts()
            ring = []
            for r in range(p):            # rank r: A's rows r, its K blocks
                acc = None                # in the order they come round
                for t in range(p):
                    owner = (r - t) % p
                    y = gemm.matmul(a[blk[r], blk[owner]], b[blk[owner]])
                    acc = y if acc is None else acc + y
                ring.append(acc)
            row = None
            for r in range(p):
                y = gemm.matmul(a[:, blk[r]], b[blk[r]])
                row = y if row is None else row + y
            column = torch.cat([gemm.matmul(a[blk[r]], b) for r in range(p)])
            torch.cuda.synchronize()
            launched = _nonzero(ops.launch_counts())
            assert launched == {"matmul": p * p + 2 * p}, launched
            shard = {"ring": (lambda: gemm.matmul(a[:kb, :kb], b[:kb]),
                              (kb, kb, n), p),
                     "row": (lambda: gemm.matmul(a[:, :kb], b[:kb]),
                             (n, kb, n), 1),
                     "column": (lambda: gemm.matmul(a[:kb], b), (kb, n, n), 1)}
            times = dict(zip(shard, self._time_turns(
                [f for f, _, _ in shard.values()], n=20)))
            for name, got in (("ring", torch.cat(ring)), ("row", row),
                              ("column", column)):
                err = (got.float() - whole.float()).abs().max().item()
                assert err <= tol[dtype] * scale, (name, dtype, err, scale)
                _, (m_, k_, n_), calls = shard[name]
                link = D.comm_model_bytes(n, n, n, p, item, name)
                print(f"      (b) {p}-rank {name:6s} {str(dtype)[6:]:8s} max "
                      f"|err| {err:.3e} of {scale:.1f} (tol "
                      f"{tol[dtype]:g} of it); a shard GEMM ({m_}, {k_}, "
                      f"{n_}) {times[name]:.4f} ms x {calls} a rank; link "
                      f"bytes a rank {link / 2 ** 20:.1f} MiB: model "
                      f"{link / self.chip.nvlink_bw * 1e3:.4f} ms over one "
                      f"link, {link / (self.chip.nvlink_bw * self.chip.nvlink_links) * 1e3:.4f} "
                      f"ms over {self.chip.nvlink_links}")
            del a, b, whole, ring, row, column
        # (c) the train launcher, --compress, in a NCCL world of 1
        self._distributed_train(train_steps, batch, seq)
        # (d) the dry-run on a fake 16x16 process group
        from repro_torch.launch import dryrun
        assert not dist.is_initialized()
        t0 = time.perf_counter()
        costs, rj = dryrun.lower_cell("qwen3-0.6b", "train_4k", verbose=False)
        dist.destroy_process_group()
        secs = time.perf_counter() - t0
        print(f"      (d) dry-run qwen3-0.6b x train_4k x {rj['mesh']} "
              f"(n_devices {rj['n_devices']}, rank 0's step under "
              f"FakeTensorMode, counted in {secs:.1f} s): collectives "
              f"{costs.collective_summary()}")
        print(f"        {rj['arch']:16s} {rj['shape']:12s} {rj['mesh']:10s} "
              f"tc={rj['t_compute'] * 1e3:9.3f}ms "
              f"tm={rj['t_memory'] * 1e3:9.3f}ms "
              f"tcoll={rj['t_collective'] * 1e3:9.3f}ms "
              f"bound={rj['bound']:10s} useful={rj['useful_ratio']:6.3f} "
              f"mfu*={rj['mfu_roofline']:6.3f} (the collective term a "
              f"model: ring-model bytes over one NVLink link)")
        assert rj["n_devices"] == 256 and rj["t_collective"] > 0, rj

    def _distributed_train(self, steps, batch, seq):
        """(c): `launch.train.main` as the CLI runs it, 4 steps with
        --compress --model-parallel 1; step 0's loss is phase 7's (the same
        weights, batch and kernels; compression acts after the loss)."""
        torch = self.torch
        from repro_torch.kernels import ops
        from repro_torch.launch import train as train_cli
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        losses = train_cli.main(["--steps", str(steps), "--batch", str(batch),
                                 "--seq", str(seq), "--warmup", "2",
                                 "--compress", "--model-parallel", "1",
                                 "--log-every", "1"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        self.dist_train_launches = ops.launch_counts()
        want = {k: v * steps for k, v in self.train_step0["want"].items()}
        got = _nonzero(self.dist_train_launches)
        print(f"      (c) launch.train --compress --model-parallel 1: "
              f"{steps} steps at {batch} x {seq} in {secs:.1f} s (the "
              f"weights' draw and the world's start included); losses "
              f"{[round(x, 4) for x in losses]}; step 0 {losses[0]!r}, "
              f"phase 7's uncompressed step 0 {self.train_step0['loss']!r}; "
              f"launches {got}")
        assert all(math.isfinite(x) for x in losses), losses
        assert losses[0] == self.train_step0["loss"], \
            (losses[0], self.train_step0["loss"])
        assert got == _nonzero(want), (got, want)

    # -- 19. the kernels line --------------------------------------------
    def kernel_rows(self):
        """One row per kernel: its launches on the main path, the max error
        over every case, and the times of its main-path decode shape."""
        meta = {
            "matmul": ("src/repro_torch/kernels/csrc/matmul_tc.cu",
                       "src/repro/kernels/matmul.py:244",
                       "bfloat16 M=4 K=1024 N=152064 [N,K] B, f32 out"),
            "gated_matmul": ("src/repro_torch/kernels/csrc/matmul_tc.cu",
                             "src/repro/kernels/matmul.py:360",
                             "bfloat16 M=4 K=1024 N=3072"),
            "matmul_batched": (
                "src/repro_torch/kernels/csrc/matmul_tc_batched.cu",
                "src/repro/kernels/matmul.py:244",
                "bfloat16 E=8 M=4 K=16384 N=6144 (mixtral-8x22b down)"),
            "gated_matmul_batched": (
                "src/repro_torch/kernels/csrc/matmul_tc_batched.cu",
                "src/repro/kernels/matmul.py:360",
                "bfloat16 E=8 M=4 K=6144 N=16384 (mixtral-8x22b)"),
            "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                             "src/repro/kernels/flash_attention.py:529",
                             "bfloat16 B=4 H=16 Hkv=8 D=128 Tk=2048 window=None"),
            "matmul_q": ("src/repro_torch/kernels/csrc/matmul_tc.cu",
                         "src/repro/kernels/matmul.py:315",
                         "bfloat16 M=4 K=1024 N=3072 int8 W none"),
            "flash_decode_paged": (
                "src/repro_torch/kernels/csrc/flash_decode.cu",
                "src/repro/kernels/flash_attention.py:716",
                "bfloat16 int8 pool B=4 H=16 Hkv=8 D=128 ps=16 pp=128 "
                "window=None"),
            "flash_decode_rows": (
                "src/repro_torch/kernels/csrc/flash_decode.cu",
                "src/repro/kernels/flash_attention.py:529",
                "bfloat16 B=4 t=5 H=16 Hkv=8 D=128 Tk=2048 window=None"),
            "flash_decode_paged_rows": (
                "src/repro_torch/kernels/csrc/flash_decode.cu",
                "src/repro/kernels/flash_attention.py:716",
                "bfloat16 bf16 pool B=4 t=5 H=16 Hkv=8 D=128 ps=16 pp=128 "
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
        # from phase 5's int8 run, the multi-row decode forms' from phase
        # 6's self-draft runs (dense, bf16 pool), the training kernels'
        # from phase 7's, the SSD kernel's from phase 9's, the batched
        # GEMMs' from phase 12's mixtral run (dense cache), the paper's
        # kernels from phase 15's
        moe = self.moe_launches[next(iter(self.moe_launches))]
        counts = {**self.launches, **self.spec_launches,
                  **{k: moe[k] for k in ("matmul_batched",
                                         "gated_matmul_batched")},
                  **{k: self.paper_launches[k]
                     for k in ("matmul_naive", "binary_op", "axpy")},
                  **{k: self.paged_launches[k]
                     for k in ("matmul_q", "flash_decode_paged")},
                  **{k: self.train_launches[k]
                     for k in ("flash_attention", "flash_attention_bwd")},
                  "ssd": self.mamba_launches["ssd"]}
        # and each main path's own run, counted from 0 (the multi-row
        # decode forms' from phase 6 only)
        paths = {"qwen3-0.6b": self.launches,
                 "qwen3-0.6b paged int8": self.paged_launches,
                 "qwen3-0.6b speculative": self.spec_launches,
                 "qwen3-0.6b training": self.train_launches,
                 "qwen3-0.6b tuned": self.tuned_launches,
                 "qwen3-0.6b tuned training": self.tuned_train_launches,
                 "qwen3-0.6b launcher --compress": self.dist_train_launches,
                 "zamba2-1.2b training": self.zamba_train_launches,
                 "mamba2-2.7b training": self.mamba_train_launches,
                 "mamba2-2.7b": self.mamba_launches,
                 "mamba2-2.7b int8": self.mamba_int8_launches,
                 "zamba2-1.2b": self.hybrid_launches,
                 "zamba2-1.2b int8": self.hybrid_int8_launches,
                 **self.config_launches,
                 **self.moe_launches,
                 **self.encdec_launches,
                 **self.family_train_launches,
                 "paper": self.paper_launches}
        # the forms a row's kernel takes beside its main shape: the batched
        # GEMM's transposed layouts (a bank's backward), the non-causal
        # backward (encdec training)
        forms = {"matmul_batched": "view", "flash_attention_bwd": "not causal"}
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
                "library_ms": rep["library_ms"], "shape": label,
                "launches_by_path": {p: c[name] for p, c in paths.items()
                                     if c.get(name)}})
            if name in forms:
                rows[-1]["forms"] = [
                    {k: c[k] for k in ("label", "ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "max_abs_err")}
                    for c in cases if forms[name] in c["label"]]
        return rows


def _print_capture(eng) -> None:
    print(f"      steps: the decode and prefill-remainder steps captured in "
          f"CUDA graphs in {eng.capture_s:.2f} s (warm-ups included), "
          f"graph pools {eng.graph_pool_bytes / 2 ** 20:.2f} MiB")


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


@contextlib.contextmanager
def _wrapper_calls():
    """Count the Python calls of the serving kernels' wrappers while the
    block runs (a replayed step makes none); yields the list of names."""
    from repro_torch.kernels import flash_attention, matmul, ssd
    calls, saved = [], []
    for mod, names in ((matmul, ("matmul_tiled", "matmul_q_tiled",
                                 "gated_matmul_tiled", "matmul_batched_tiled",
                                 "gated_matmul_batched_tiled")),
                       (flash_attention, ("flash_decode",
                                          "flash_decode_paged")),
                       (ssd, ("ssd_chunked",))):
        for name in names:
            fn = getattr(mod, name)
            saved.append((mod, name, fn))

            def counted(*args, _fn=fn, _name=name, **kw):
                calls.append(_name)
                return _fn(*args, **kw)
            setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


#: The fewest steps the falling-loss gate takes: over 8 steps at lr 1e-3,
#: Adam's first, nearly sign(g)-sized steps lifted a zamba2 loss drawn
#: from another generator above its start (10.909 to 11.547), the plain
#: versions alike, so a last-against-first gate judged the draw.
GATE_STEPS = 16


def loss_falls(losses):
    """The falling-loss gate of a training run of at least GATE_STEPS
    steps: the mean loss of its last quarter of steps below the mean of
    its first quarter. Returns (leading mean, trailing mean, holds)."""
    if len(losses) < GATE_STEPS:
        raise ValueError(f"the gate takes {GATE_STEPS} steps or more, got "
                         f"{len(losses)}")
    q = len(losses) // 4
    lead = statistics.fmean(losses[:q])
    trail = statistics.fmean(losses[-q:])
    return lead, trail, trail < lead


@contextlib.contextmanager
def _served_off_static():
    """While open, collect the distinct GEMM calls whose plan a tuning
    cache served off the static plan, {(op, dtype, m, k, n, epilogue):
    the served instance's name}: a wrapper of `kernels.matmul._served`,
    which every plan function asks first."""
    from repro_torch.kernels import matmul as tmm
    served, off = tmm._served, {}

    def wrapper(op, dtype, m, k, n, epilogue="none"):
        plan = served(op, dtype, m, k, n, epilogue)
        if plan is not None and plan != tmm.static_plan(op, dtype, m, k, n):
            off[(op, dtype, m, k, n, epilogue)] = plan.name
        return plan
    tmm._served = wrapper
    try:
        yield off
    finally:
        tmm._served = served


def _off_counts(off: dict) -> str:
    """The count of `_served_off_static`'s calls, and of them by M."""
    by_m = {}
    for _, _, m, _, _, _ in off:
        by_m[m] = by_m.get(m, 0) + 1
    return f"{len(off)} (" + ", ".join(
        f"M={m}: {c}" for m, c in sorted(by_m.items())) + ")"


def _layout_names(layouts) -> str:
    """(a_km, b_nk, out) triples as "MK.KN", "MK.NK f32", ..."""
    return ",".join(f"{'KM' if t_a else 'MK'}.{'NK' if t_b else 'KN'}"
                    f"{' f32' if out == 'float32' else ''}"
                    for t_a, t_b, out in layouts)


def _out_dtypes(torch, layouts) -> list:
    return [None if out is None else getattr(torch, out)
            for _, _, out in layouts]


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _no_launches(**counts) -> dict:
    """Every kernel's launch count 0, but for `counts`."""
    from repro_torch.kernels import ops
    return {**dict.fromkeys(ops.launch_counts(), 0), **counts}


def _print_trace(prof, what: str, wall_ms: float, n: int = 1,
                 expect=(), own=None):
    """The card's busy time in a torch.profiler trace of `n` repeats of
    `what`, by kernel group with its launches, against the wall time of
    one (the profiler's own host cost included, so the idle share read
    here is an upper bound). own: {name of a host op or annotation:
    group}, the kernels launched below such an op (an autograd node's
    backward, say) form a group of their own (a kernel carries the
    correlation id of its launch call on the host, cudaLaunchKernel and
    the like, whose parents are the ops it ran under). Each group in
    `expect` must show in it. Returns the busy ms of one repeat (None: no
    device time recorded)."""
    from torch.autograd import DeviceType
    own = own or {}
    events = prof.events()
    owner = {}       # correlation id of a launch call -> the group it is in
    for e in events if own else ():
        if e.device_type != DeviceType.CPU or not e.name.startswith("cu"):
            continue
        p = e.cpu_parent
        while p is not None and e.id not in owner:
            owner.update({e.id: g for k, g in own.items() if k in p.name})
            p = p.cpu_parent
    busy, count = {}, {}
    for e in events:
        # an annotation's span on the card is not a kernel
        if e.device_type != DeviceType.CUDA or e.name in own \
                or getattr(e, "is_user_annotation", False):
            continue
        group = owner.get(e.id) or _kernel_group(e.name)
        busy[group] = busy.get(group, 0.0) + e.time_range.elapsed_us() / 1e3
        count[group] = count.get(group, 0) + 1
    if not busy:
        print("      trace: the profiler recorded no device time "
              "(not measured)")
        return None
    each = " a step" if n > 1 else ""
    total = sum(busy.values()) / n
    parts = ", ".join(f"{g} {busy[g] / n:.3f} ms ({count[g] // n} launches)"
                      for g in sorted(busy, key=busy.get, reverse=True))
    print(f"      trace: {what} under torch.profiler: wall {wall_ms:.2f} ms"
          f"{each}; card busy {total:.3f} ms{each}: {parts}; idle share "
          f"{1 - total / wall_ms:.3f}")
    missing = set(expect) - set(busy)
    assert not missing, f"{what}: no {sorted(missing)} kernel in the trace"
    return total


def _kernel_group(name: str) -> str:
    """A profiler kernel name's group: one of the port's kernels (by the
    template arguments of its instantiation), memcpy, or other."""
    if "gated_matmul_batched" in name:    # the batched forms (expert banks)
        return "gated_matmul_batched"
    if "matmul_batched" in name:
        return "matmul_batched"
    if "gated_matmul_kernel" in name:     # mma_, tma_ (bf16) and FMA (f32)
        return "gated_matmul"
    if "matmul_kernel" in name:           # mma_, tma_ (bf16) and FMA (f32);
        # the int8-weight instances take int8 ("signed char") B
        return "matmul_q" if "signed char" in name else "matmul"
    if "flash_decode" in name:            # the split and merge kernels
        return "flash_decode" if "false, false>" in name \
            else "flash_decode_paged"
    if "flash_attn_fwd" in name:          # the bf16 (mma) and f32 forwards
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


def _sdpa_train(torch, F, q, k, v, mask, do=None, causal=True):
    """The library yardstick for training attention (timed only): SDPA's
    forward, causal (a bool mask with a window) or not, and with `do` its
    forward and backward."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(do is not None)
                  for x in (q, k, v))
    g = q.shape[2] // k.shape[2]
    if torch.__version__ >= "2.5":
        kw = {"enable_gqa": True}
    else:
        kt, vt, kw = kt.repeat_interleave(g, 1), vt.repeat_interleave(g, 1), {}
    kw.update(is_causal=causal) if mask is None \
        else kw.update(attn_mask=mask)

    def run():
        o = F.scaled_dot_product_attention(qt, kt, vt, **kw)
        if do is not None:
            o.backward(do.transpose(1, 2))
        return o
    return run


if __name__ == "__main__":
    sys.exit(main())
