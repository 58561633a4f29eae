"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --steps 3 --batch 2 --seq 32      # the plain versions
    PYTHONPATH=src python -m repro_torch.launch.train --steps 4 \
        --batch 4 --seq 512                              # full width, on the card

Trains qwen3-0.6b (or its `--reduced` test config) from random weights
(`torch.Generator().manual_seed(--seed)`) on `SyntheticLM` batches with
AdamW and a cosine schedule. Runs on the card unless `--device cpu` is
given, and raises where there is no card. Not ported yet: the JAX
launcher's --backend, --autotune, --model-parallel, --compress,
--ckpt-dir and --fail-at.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.training import train_loop as TL


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_NAMES)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps),
                clip_norm=1.0)
    state = TL.init_state(cfg, opt, torch.Generator().manual_seed(args.seed),
                          device)
    step_fn = TL.make_train_step(cfg, opt, accum=args.accum)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       seed=args.seed)
    n_params = sum(x.numel() for x in leaves(state.params))
    print(f"arch={cfg.name} params={n_params / 1e6:.2f}M device={device}")

    losses = []
    t0 = time.time()
    for step in range(args.steps):
        t1 = time.perf_counter()
        batch = {k: torch.as_tensor(v, dtype=torch.long, device=device)
                 for k, v in data.batch_at(step).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))      # waits for the step
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{(time.perf_counter() - t1) * 1e3:.0f}ms")
    print(f"done {args.steps} steps in {time.time() - t0:.1f}s")
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
