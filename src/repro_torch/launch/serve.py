"""Serving CLI of the port: a thin driver over the continuous-batching
engine, on the card unless `--device cpu` is given.

Mixed-length trace:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --requests 8 --max-slots 4 --prompt-len-min 64 --prompt-len-max 512

Uniform single batch (all requests at t=0, equal lengths):

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --batch 4 --prompt-len 32 --gen 16 --device cpu

Prefix-heavy chat over a paged int8 KV pool (a shared 392-token system
prompt; prefix pages are shared, and copied on write):

    PYTHONPATH=src python -m repro_torch.launch.serve --kv-layout paged \
        --quant-kv int8 --prefix-len 392

Mamba-2 (attention-free), and Zamba2 (a Mamba-2 backbone with one shared
attention block, its KV caches dense); their recurrent state takes no
page pool or int8 pages:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --requests 8 --max-slots 4 --prompt-len-min 64 --prompt-len-max 512
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --requests 8 --max-slots 4 --prompt-len-min 64 --prompt-len-max 512

The moe family (mixtral-8x22b, arctic-480b) at its reduced size; at full
width and depth neither fits one card (chip_smoke.py serves them at a
cut depth). A moe target takes a draft: its verify step routes the
slots' rows as one group, where capacity can drop an assignment that a
decode step keeps, so --check-exact holds only the requests whose verify
rows dropped nothing:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
        --reduced --device cpu --requests 4 --max-slots 2 --kv-layout paged
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
        --reduced --device cpu --requests 4 --max-slots 2 \
        --draft mixtral-8x22b --spec-k 4

whisper-tiny (family encdec), each request with its own 1500 x 384
encoder frames drawn from the trace's seed (a page pool and a draft are
refused):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
        --requests 8 --max-slots 4 --prompt-len-min 8 --prompt-len-max 192

Bursty arrivals with two priority levels, deadlines 2 s after arrival and
a temperature sampler over the 50 likeliest tokens:

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 16 \
        --workload bursty --arrival-rate 4 --priority-levels 0,1 \
        --deadline 2 --sampler temperature --top-k 50

Speculative decoding (a draft proposes --spec-k tokens a round, the
target verifies them in one forward; --check-exact holds the greedy
streams to a dense engine's without a draft):

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 \
        --workload prefix_heavy --kv-layout paged --draft qwen3-0.6b \
        --spec-k 4 --check-exact

Chaos mode (deterministic fault injection, `serving.faults.FaultInjector`:
a NaN logits row, a poisoned KV page, kernel faults that are retried and
then rebuild the captured steps, a slow step, a denied admission); the
run must survive it, and --check-exact holds every request that
finished to the fault-free dense engine's stream:

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --requests 8 --max-slots 2 --kv-layout paged \
        --page-size 8 --chaos-nan-step 3 --chaos-kernel-steps 1,4 \
        --chaos-deny-admissions 2 --check-exact

Tuned tiles (`repro_torch.tuning`): --autotune times the instances of
every GEMM shape the engine runs on the card and caches the winners
(`REPRO_TORCH_TUNING_CACHE`, by default ~/.cache/repro_torch/tuning.json),
and --backend tuned serves them, bit for bit the static plans' outputs:

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 4 \
        --max-slots 4 --gen 16 --backend tuned --autotune

Weights are random, drawn from a torch.Generator seeded with --seed (a
draft's with --seed + 1).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import tuning
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import (DEFAULT_PREFILL_CHUNK, TRACES,
                                 FaultInjector, ServingEngine, make_sampler,
                                 make_trace, prefix_heavy_trace,
                                 synthetic_trace)
from repro_torch.serving.engine import check_modes
from repro_torch.serving.request import FINISHED, TERMINAL


def build_workload(cfg, args, rng):
    """A named scenario of the trace registry when --workload is set;
    else prefix-heavy chat when --prefix-len is set, the mixed-length
    trace when --requests is set, else the uniform batch. Deadlines,
    priorities and fixed-size bursts apply to all of them (the bursty
    scenario draws its own group sizes)."""
    ft = dict(deadline=args.deadline or None,
              priority_levels=tuple(int(p) for p in
                                    args.priority_levels.split(",")),
              burst_size=args.burst_size)
    if args.workload:
        n = args.requests or args.batch
        kw = dict(gen=args.gen, arrival_rate=args.arrival_rate, **ft)
        if args.workload == "bursty":
            kw.pop("burst_size")
        return make_trace(args.workload, cfg, n, rng=rng, **kw)
    if args.prefix_len:
        return prefix_heavy_trace(cfg, args.requests or args.batch, rng=rng,
                                  prefix_len=args.prefix_len,
                                  suffix_range=(args.suffix_min,
                                                args.suffix_max),
                                  gen=args.gen,
                                  arrival_rate=args.arrival_rate, **ft)
    if args.requests:
        return synthetic_trace(cfg, args.requests, rng=rng,
                               len_range=(args.prompt_len_min,
                                          args.prompt_len_max),
                               gen=args.gen, arrival_rate=args.arrival_rate,
                               **ft)
    return synthetic_trace(cfg, args.batch, rng=rng,
                           len_range=(args.prompt_len, args.prompt_len),
                           gen=args.gen, arrival_rate=0.0, **ft)


def build_injector(args):
    """The FaultInjector the --chaos-* flags script, or None when none is
    set."""
    steps = lambda s: tuple(int(x) for x in s.split(",")) if s else ()
    nan_rows = ({int(args.chaos_nan_step): int(args.chaos_nan_slot)}
                if args.chaos_nan_step >= 0 else {})
    corrupt = ({int(args.chaos_corrupt_step): int(args.chaos_corrupt_slot)}
               if args.chaos_corrupt_step >= 0 else {})
    slow = {s: args.chaos_slow_seconds for s in steps(args.chaos_slow_steps)}
    kernel = steps(args.chaos_kernel_steps)
    deny = steps(args.chaos_deny_admissions)
    if not (nan_rows or corrupt or slow or kernel or deny):
        return None
    return FaultInjector(nan_rows=nan_rows, corrupt_pages=corrupt,
                         kernel_fail_steps=kernel, slow_steps=slow,
                         deny_admissions=deny)


def check_outputs(cfg, engine, requests):
    """Every request ended; a FINISHED one generated its whole quota (or
    stopped at eos); every emitted token is a real vocab id, and the
    engine's token count is the streams'."""
    for req in requests:
        toks = np.asarray(req.generated)
        assert req.status in TERMINAL, (req.rid, req.status)
        if req.status == FINISHED:
            assert toks.size == req.max_new_tokens or (
                engine.eos_id is not None and toks[-1] == engine.eos_id), \
                (req.rid, toks.size, req.max_new_tokens)
        if toks.size:
            assert ((toks >= 0) & (toks < cfg.vocab)).all(), \
                (req.rid, toks.min(), toks.max(), cfg.vocab)
    assert sum(r.n_generated for r in requests) == engine.tokens_emitted
    assert engine.scheduler.n_active == 0 and engine.scheduler.n_waiting == 0


def check_chaos(engine, report, requests):
    """A chaos run survived: no crashed step, goodput above 0, every
    request in a terminal state that the report counts, and at least one
    scripted fault fired (a script that fires nothing tested nothing)."""
    assert report["crashed_steps"] == 0, report
    assert report["goodput"] > 0.0, report
    assert report["useful_tokens"] > 0, report
    terminal = (report["n_finished"] + report["expired"]
                + report["cancelled"] + report["quarantined"])
    assert terminal == len(requests), (terminal, len(requests), report)
    inj = report["faults_injected"]
    assert sum(inj.values()) > 0, f"no scripted fault fired: {inj}"
    print(f"chaos: survived {sum(inj.values())} injected fault(s) "
          f"({inj}); goodput {report['goodput']:.2f}, "
          f"quarantined {report['quarantined']}, "
          f"preempted {report['preempted']}, "
          f"degraded={report['degraded']} (steps rebuilt)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=0,
                    help="number of requests in the mixed-length trace "
                         "(0 = uniform single-batch mode)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrival rate in req/s (0 = all at t=0)")
    ap.add_argument("--max-slots", type=int, default=0,
                    help="cache slot pool size (default: --batch, or 4)")
    ap.add_argument("--prompt-len-min", type=int, default=8)
    ap.add_argument("--prompt-len-max", type=int, default=48)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16,
                    help="tokens to generate per request")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sampler", choices=("greedy", "temperature"),
                    default="greedy")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="temperature sampling over the k likeliest tokens "
                         "(0 = the whole vocab)")
    ap.add_argument("--kv-layout", choices=("dense", "paged"),
                    default="dense",
                    help="KV cache layout: per-slot rows, or a shared "
                         "page pool with prefix sharing + copy-on-write")
    ap.add_argument("--quant-kv", choices=("off", "int8"), default="off",
                    help="int8 KV pages (requires --kv-layout paged)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page in paged mode")
    ap.add_argument("--kv-pool-pages", type=int, default=0,
                    help="physical page pool size (0 = dense-equivalent "
                         "capacity: max_slots * pages_per_slot)")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="shared system-prompt length: > 0 switches the "
                         "workload to the prefix-heavy chat trace")
    ap.add_argument("--suffix-min", type=int, default=2)
    ap.add_argument("--suffix-max", type=int, default=12)
    ap.add_argument("--workload", choices=sorted(TRACES), default="",
                    help="named scenario of the trace registry (overrides "
                         "the implicit choice of trace)")
    ap.add_argument("--draft", choices=ARCH_NAMES, default="",
                    help="draft model arch: speculative decoding (the "
                         "draft proposes --spec-k tokens a round, the "
                         "target verifies them in one forward)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed a round")
    ap.add_argument("--check-exact", action="store_true",
                    help="serve the trace again on a dense engine without "
                         "a draft and require the same token streams "
                         "(greedy only)")
    ap.add_argument("--deadline", type=float, default=0.0,
                    help="deadline a request, seconds after its arrival "
                         "(0 = none)")
    ap.add_argument("--priority-levels", type=str, default="0",
                    help="comma-separated priority levels drawn uniformly "
                         "a request (e.g. '0,1')")
    ap.add_argument("--burst-size", type=int, default=1,
                    help="requests an arrival burst (> 1 = bursty "
                         "arrivals at the same long-run rate)")
    ap.add_argument("--chaos-nan-step", type=int, default=-1,
                    help="decode step at which one slot's logits row is "
                         "NaN'd (-1 = off)")
    ap.add_argument("--chaos-nan-slot", type=int, default=0)
    ap.add_argument("--chaos-corrupt-step", type=int, default=-1,
                    help="decode step before which one slot's private KV "
                         "page (a dense slot's rows) is NaN-poisoned "
                         "(-1 = off)")
    ap.add_argument("--chaos-corrupt-slot", type=int, default=0)
    ap.add_argument("--chaos-kernel-steps", type=str, default="",
                    help="comma-separated decode steps raising a simulated "
                         "kernel fault (retry, then a rebuild of the "
                         "captured steps)")
    ap.add_argument("--chaos-slow-steps", type=str, default="",
                    help="comma-separated decode steps slowed by "
                         "--chaos-slow-seconds (straggler flagging)")
    ap.add_argument("--chaos-slow-seconds", type=float, default=0.05)
    ap.add_argument("--chaos-deny-admissions", type=str, default="",
                    help="comma-separated admission ordinals that see an "
                         "exhausted KV pool (preemption path; paged mode)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "PyTorch versions)")
    ap.add_argument("--backend", default="cuda",
                    help="cuda (the GEMMs on their static tile plans) or "
                         "tuned (on the tuning cache's winners, the same "
                         "bits)")
    ap.add_argument("--autotune", action="store_true",
                    help="tune the engine's uncached shapes at startup, "
                         "on the card")
    args = ap.parse_args(argv)
    if args.check_exact and args.sampler != "greedy":
        ap.error("--check-exact requires --sampler greedy")
    try:
        tuning.check_backend(args.backend)
    except ValueError as e:
        ap.error(str(e))

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    check_modes(cfg, args.kv_layout, args.quant_kv, "off")
    rng = np.random.default_rng(args.seed)
    work = build_workload(cfg, args, rng)
    injector = build_injector(args)
    max_slots = args.max_slots or (args.batch if not args.requests else 4)
    max_len = max(len(it.prompt) + it.gen for it in work)

    with tuning.tuned(warm_tuning(cfg, args, work, max_slots, max_len,
                                  device)):
        return serve(cfg, args, device, work, injector, max_slots, max_len)


def warm_tuning(cfg, args, work, max_slots, max_len, device):
    """The reference's startup hook: under `--backend tuned` or with
    `--autotune`, check the tuning cache for the shapes the engine runs
    (the admission prefill at batch 1 over the prompts' buckets and the
    one-token remainder steps; the decode step at max_slots rows over the
    cache's depth), tuning the misses on the card with `--autotune`.
    Returns the cache whose winners the run serves (`--backend tuned`),
    else None: the static plans."""
    if args.backend != "tuned" and not args.autotune:
        return None
    chunk = DEFAULT_PREFILL_CHUNK
    buckets = sorted({(len(it.prompt) - len(it.prompt) % chunk)
                      or len(it.prompt) for it in work} | {1})
    rep = tuning.warm_start(cfg, 1, buckets, autotune=args.autotune,
                            device=device)
    print(tuning.describe_warm_start(rep))
    # decode attends over the engine's cache depth, which rounds max_len
    # up to an attn_chunk multiple (ServingEngine.__init__)
    a = cfg.attn_chunk
    cache_len = max_len + (a - max_len % a if max_len > a
                           and max_len % a else 0)
    rep = tuning.warm_start(cfg, max_slots, 1, autotune=args.autotune,
                            decode_len=cache_len, device=device)
    print(tuning.describe_warm_start(rep))
    return tuning.get_cache() if args.backend == "tuned" else None


def serve(cfg, args, device, work, injector, max_slots, max_len):
    """Serve `work` on an engine built from args and print its report."""
    params = M.init_params(cfg, torch.Generator().manual_seed(args.seed),
                           device)
    draft = None
    if args.draft:
        dcfg = get_config(args.draft, reduced=args.reduced)
        draft = (dcfg, M.init_params(
            dcfg, torch.Generator().manual_seed(args.seed + 1), device))
    sampler = make_sampler(args.sampler, temperature=args.temperature,
                           top_k=args.top_k, seed=args.seed)
    engine = ServingEngine(cfg, params, max_slots=max_slots, max_len=max_len,
                           device=device, kv_layout=args.kv_layout,
                           quant_kv=args.quant_kv, page_size=args.page_size,
                           kv_pool_pages=args.kv_pool_pages or None,
                           sampler=sampler, fault_injector=injector,
                           draft=draft, spec_k=args.spec_k)
    del draft
    if not args.check_exact:
        del params
    requests = [engine.submit(it.prompt, it.gen, arrival_time=it.arrival,
                              deadline=it.deadline, priority=it.priority,
                              enc_frames=it.enc_frames)
                for it in work]
    report = engine.run()

    for r in requests:
        lat = f"{r.latency*1e3:7.1f}ms" if r.latency is not None else "   --  "
        ttft = f"{r.ttft*1e3:7.1f}ms" if r.ttft is not None else "   --  "
        print(f"req {r.rid:3d} prompt={r.prompt_len:3d} "
              f"gen={r.n_generated:3d} ttft={ttft} latency={lat} "
              f"[{r.status}]" + (f" {r.error}" if r.error else ""))
    print(f"arch={cfg.name} slots={max_slots} requests={len(requests)} "
          f"prefill {report['prefill_tok_s']:.1f} tok/s, "
          f"decode {report['decode_tok_s']:.1f} tok/s "
          f"(occupancy {report['mean_occupancy']:.2f}/{max_slots}), "
          f"latency p50 {report['latency_p50_s']*1e3:.0f}ms "
          f"p95 {report['latency_p95_s']*1e3:.0f}ms, "
          f"ttft p50 {report['ttft_p50_s']*1e3:.0f}ms")
    print(f"requests: goodput {report['goodput']:.2f} "
          f"({report['useful_tokens']}/{engine.tokens_emitted} tokens), "
          f"expired {report['expired']}, cancelled {report['cancelled']}, "
          f"preempted {report['preempted']}, "
          f"quarantined {report['quarantined']}, "
          f"deadline-miss rate {report['deadline_miss_rate']:.2f}, "
          f"stragglers {report['straggler_steps']}")
    if "spec_acceptance_rate" in report:
        print(f"speculative: draft={args.draft} k={args.spec_k}, "
              f"{report['spec_rounds']} rounds, acceptance "
              f"{report['spec_acceptance_rate']:.2f} "
              f"({report['spec_accepted']}/{report['spec_proposed']}), "
              f"tokens/step {report['tokens_per_step']:.2f}, "
              f"draft time {report['draft_time_s']*1e3:.0f}ms")
    if "verify_dropped" in report:
        print(f"verify drops: {report['verify_dropped']} expert assignments "
              f"of real rows ({report['verify_dropped_frac']:.4f}), "
              f"{report['verify_rounds_dropping']} of "
              f"{report['spec_rounds']} rounds dropping")
    if "kv_pool" in report:
        kv = report["kv_pool"]
        print(f"kv pool: {kv['n_pages']} pages x {kv['page_size']} tok, "
              f"peak resident {kv['peak_resident']}, "
              f"peak sharing {kv['peak_sharing_ratio']:.2f}x, "
              f"{kv['shared_page_hits']} shared hits, "
              f"{kv['cow_copies']} CoW copies")
    check_outputs(cfg, engine, requests)
    if injector is not None:
        check_chaos(engine, report, requests)

    if args.check_exact:
        # the same trace on a dense engine without a draft or faults: the
        # paged, speculative or chaos engine must emit the same greedy
        # streams (a moe target's requests whose verify rows dropped
        # nothing; under chaos, the requests that finished: a fault ends
        # its request early on purpose)
        del engine
        ref = ServingEngine(cfg, params, max_slots=max_slots,
                            max_len=max_len, device=device)
        ref_reqs = [ref.submit(it.prompt, it.gen, arrival_time=it.arrival,
                               enc_frames=it.enc_frames)
                    for it in work]
        ref.run()
        n_cmp = n_dropped = 0
        for a, b in zip(requests, ref_reqs):
            if a.status != FINISHED:
                continue
            if a.verify_dropped:
                n_dropped += 1
                continue
            assert a.generated == b.generated, \
                (a.rid, a.generated, b.generated)
            n_cmp += 1
        left = (f" ({n_dropped} left out: their verify rows dropped expert "
                f"assignments)" if n_dropped else "")
        assert n_cmp > 0, "no finished requests to compare" + left
        print(f"check-exact: {n_cmp} token streams match the dense "
              f"engine without a draft{left}")

    if not args.requests and not args.prefix_len and not args.workload:
        gen = np.stack([np.asarray(r.generated, np.int32) for r in requests])
        print("generated ids[0,:16]:", gen[0, :16].tolist())
        return gen
    return report


if __name__ == "__main__":
    main()
