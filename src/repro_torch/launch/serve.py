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

Mamba-2 (attention-free; its recurrent state takes no page pool or int8):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --requests 8 --max-slots 4 --prompt-len-min 64 --prompt-len-max 512

Weights are random, drawn from a torch.Generator seeded with --seed.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import (ServingEngine, prefix_heavy_trace,
                                 synthetic_trace)
from repro_torch.serving.engine import check_modes
from repro_torch.serving.request import FINISHED


def build_workload(cfg, args, rng):
    """Prefix-heavy chat when --prefix-len is set, the mixed-length trace
    when --requests is set, else the uniform batch."""
    if args.prefix_len:
        return prefix_heavy_trace(cfg, args.requests or args.batch, rng=rng,
                                  prefix_len=args.prefix_len,
                                  suffix_range=(args.suffix_min,
                                                args.suffix_max),
                                  gen=args.gen)
    if args.requests:
        return synthetic_trace(cfg, args.requests, rng=rng,
                               len_range=(args.prompt_len_min,
                                          args.prompt_len_max),
                               gen=args.gen)
    return synthetic_trace(cfg, args.batch, rng=rng,
                           len_range=(args.prompt_len, args.prompt_len),
                           gen=args.gen)


def check_outputs(cfg, engine, requests):
    """Every request finished with its full quota of real vocab ids."""
    for req in requests:
        toks = np.asarray(req.generated)
        assert req.status == FINISHED, (req.rid, req.status)
        assert toks.size == req.max_new_tokens, \
            (req.rid, toks.size, req.max_new_tokens)
        assert ((toks >= 0) & (toks < cfg.vocab)).all(), \
            (req.rid, toks.min(), toks.max(), cfg.vocab)
    assert sum(r.n_generated for r in requests) == engine.tokens_emitted
    assert engine.scheduler.n_active == 0 and engine.scheduler.n_waiting == 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=0,
                    help="number of requests in the mixed-length trace "
                         "(0 = uniform single-batch mode)")
    ap.add_argument("--max-slots", type=int, default=0,
                    help="cache slot pool size (default: --batch, or 4)")
    ap.add_argument("--prompt-len-min", type=int, default=8)
    ap.add_argument("--prompt-len-max", type=int, default=48)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16,
                    help="tokens to generate per request")
    ap.add_argument("--seed", type=int, default=0)
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    check_modes(cfg, args.kv_layout, args.quant_kv, "off")
    rng = np.random.default_rng(args.seed)
    work = build_workload(cfg, args, rng)
    max_slots = args.max_slots or (args.batch if not args.requests else 4)
    max_len = max(len(it.prompt) + it.gen for it in work)

    params = M.init_params(cfg, torch.Generator().manual_seed(args.seed),
                           device)
    engine = ServingEngine(cfg, params, max_slots=max_slots, max_len=max_len,
                           device=device, kv_layout=args.kv_layout,
                           quant_kv=args.quant_kv, page_size=args.page_size,
                           kv_pool_pages=args.kv_pool_pages or None)
    del params
    requests = [engine.submit(it.prompt, it.gen, arrival_time=it.arrival)
                for it in work]
    report = engine.run()

    for r in requests:
        lat = f"{r.latency*1e3:7.1f}ms" if r.latency is not None else "   --  "
        ttft = f"{r.ttft*1e3:7.1f}ms" if r.ttft is not None else "   --  "
        print(f"req {r.rid:3d} prompt={r.prompt_len:3d} "
              f"gen={r.n_generated:3d} ttft={ttft} latency={lat} "
              f"[{r.status}]")
    print(f"arch={cfg.name} slots={max_slots} requests={len(requests)} "
          f"prefill {report['prefill_tok_s']:.1f} tok/s, "
          f"decode {report['decode_tok_s']:.1f} tok/s "
          f"(occupancy {report['mean_occupancy']:.2f}/{max_slots}), "
          f"latency p50 {report['latency_p50_s']*1e3:.0f}ms "
          f"p95 {report['latency_p95_s']*1e3:.0f}ms, "
          f"ttft p50 {report['ttft_p50_s']*1e3:.0f}ms")
    if "kv_pool" in report:
        kv = report["kv_pool"]
        print(f"kv pool: {kv['n_pages']} pages x {kv['page_size']} tok, "
              f"peak resident {kv['peak_resident']}, "
              f"peak sharing {kv['peak_sharing_ratio']:.2f}x, "
              f"{kv['shared_page_hits']} shared hits, "
              f"{kv['cow_copies']} CoW copies")
    check_outputs(cfg, engine, requests)

    if not args.requests and not args.prefix_len:
        gen = np.stack([np.asarray(r.generated, np.int32) for r in requests])
        print("generated ids[0,:16]:", gen[0, :16].tolist())
        return gen
    return report


if __name__ == "__main__":
    main()
