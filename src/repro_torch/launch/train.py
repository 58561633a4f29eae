"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --steps 3 --batch 2 --seq 32      # the plain versions
    PYTHONPATH=src python -m repro_torch.launch.train --steps 4 \
        --batch 4 --seq 512                              # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --steps 8 --ckpt-dir D --ckpt-every 2 --fail-at 3
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --steps 3 --batch 2 --seq 32 --compress
    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train \
        --model-parallel M [--compress]                  # N cards

Trains `--arch` (every arch whose family `models.model` trains,
`TRAIN_FAMILIES`: the dense configs, qwen2-vl-2b on text, mixtral-8x22b
and arctic-480b with their router losses in the loss, mamba2-2.7b and
zamba2-1.2b), or its `--reduced` test config, from random weights
(`torch.Generator().manual_seed(--seed)`) on `SyntheticLM` batches with
AdamW and a cosine schedule. whisper-tiny is not offered: its batches
need encoder frames, which `SyntheticLM` does not carry (nor does the
JAX launcher's); it trains through `training.train_loop.make_train_step`
on batches with "enc_frames". The full mixtral-8x22b and arctic-480b do
not fit one card (their f32 params and AdamW moments alone are ~2.3 TB
and ~7.7 TB); `--reduced` trains them on the CPU. The step updates
the train state in place (`make_train_step(donate=True)`), as the JAX
launcher donates it. Runs on the card unless `--device cpu` is given,
and raises where there is no card.

With `--ckpt-dir`, the run is supervised, as the JAX launcher's is: it
resumes from the directory's latest checkpoint, saves the state every
`--ckpt-every` steps without blocking (`checkpoint.Checkpointer`, 3
kept), and `--fail-at` injects a failure before each step it names,
after which the latest checkpoint is restored into the state's own
tensors and the steps from it run again (`distributed.Supervisor`). The
losses hold one entry for every step run, replays included. A step's
time ends with the read of its loss, which waits for the card, so the
straggler detector sees the card's work.

`--backend tuned` runs the GEMMs on the tuning cache's winners
(`repro_torch.tuning`; the same bits as the static plans), and
`--autotune` tunes the step's uncached shapes, its backward's included,
on the card before the state is made.

The run is on a ("data", "model") mesh of the world that exists
(`launch.mesh.host_mesh`): torchrun's (nccl on the cards, one a rank), a
gloo group the caller started with `--device cpu`, or else a world of 1
in this process. `--model-parallel M` makes "model" M wide: the dense
family's step is then tensor-parallel (each rank holds its block of the
params), and every other family raises NotImplementedError. The rest of
the world is "data": each data rank trains on its block of the batch's
rows, the gradients averaged. `--compress` compresses the gradients to
int8 with error feedback after that average (`distributed.compression`).
One card holds a world of 1 only. Rank 0 prints. `--ckpt-dir` takes a
world of 1.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import tuning
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core.device import resolve_device
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     Supervisor)
from repro_torch.launch.mesh import host_mesh
from repro_torch.models.model import TRAIN_FAMILIES
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.training import train_loop as TL

#: The archs offered: every trained family's but encdec (no frames in
#: the synthetic batches).
TRAIN_ARCHS = tuple(a for a in ARCH_NAMES
                    if get_config(a).family in TRAIN_FAMILIES
                    and get_config(a).family != "encdec")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=TRAIN_ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the width of the mesh's \"model\" axis")
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=(),
                    help="inject simulated failures at these steps")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--backend", default="cuda",
                    help="cuda (the GEMMs on their static tile plans) or "
                         "tuned (on the tuning cache's winners, the same "
                         "bits)")
    ap.add_argument("--autotune", action="store_true",
                    help="tune the step's uncached shapes at startup, on "
                         "the card")
    args = ap.parse_args(argv)
    try:
        tuning.check_backend(args.backend)
    except ValueError as e:
        ap.error(str(e))

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    tuned = None
    if args.backend == "tuned" or args.autotune:
        # check (and with --autotune fill) the cache for the step's
        # shapes, its backward's included, before the state is made
        rep = tuning.warm_start(cfg, args.batch, args.seq,
                                autotune=args.autotune, backward=True,
                                device=device)
        print(tuning.describe_warm_start(rep))
        if args.backend == "tuned":
            tuned = tuning.get_cache()
    with tuning.tuned(tuned), host_mesh(args.model_parallel, device) as mesh:
        return train(cfg, args, device, mesh)


def train(cfg, args, device, mesh=None):
    """Train `cfg` as args say on `mesh` (None: this process alone);
    returns the losses, one a step run."""
    import torch.distributed as dist
    rank = dist.get_rank() if mesh is not None else 0
    world = dist.get_world_size() if mesh is not None else 1
    if args.ckpt_dir and world > 1:
        raise ValueError(f"--ckpt-dir takes a world of 1, not {world}")
    say = print if rank == 0 else (lambda *a, **k: None)
    opt = AdamW(lr=cosine_schedule(args.lr, args.warmup, args.steps),
                clip_norm=1.0)
    state = TL.init_state(cfg, opt, torch.Generator().manual_seed(args.seed),
                          device, compress=args.compress, mesh=mesh)
    step_fn = TL.make_train_step(cfg, opt, accum=args.accum, donate=True,
                                 compress=args.compress, mesh=mesh)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       seed=args.seed)
    n_params = sum(x.numel() for x in leaves(state.params))
    shape = "none" if mesh is None else dict(zip(mesh.mesh_dim_names,
                                                 mesh.shape))
    say(f"arch={cfg.name} params={n_params / 1e6:.2f}M (a rank's) "
        f"device={device} mesh={shape} compress={args.compress}")

    losses = []

    def on_metrics(step, metrics, dt):
        losses.append(metrics["loss"])
        if step % args.log_every == 0:
            say(f"step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} {dt * 1e3:.0f}ms")

    def run_step(state, step):
        batch = {k: torch.as_tensor(v, dtype=torch.long, device=device)
                 for k, v in data.batch_at(step).items()}
        state, metrics = step_fn(state, batch)
        return state, dict(metrics, loss=float(metrics["loss"]))  # waits

    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir, keep=3)
        sup = Supervisor(ckpt, checkpoint_every=args.ckpt_every)
        injector = FailureInjector(tuple(args.fail_at)) if args.fail_at \
            else None
        start = ckpt.latest_step() or 0
        if start:
            state = ckpt.restore(start, state)
            say(f"resumed from checkpoint step {start}")
        t0 = time.time()
        state, step = sup.run_resilient(
            state, run_step, args.steps, start_step=start,
            injector=injector, on_metrics=on_metrics)
        say(f"done at step {step} in {time.time() - t0:.1f}s "
              f"(restarts={sup.restarts}, "
              f"stragglers={len(sup.straggler.flagged)})")
    else:
        t0 = time.time()
        for step in range(args.steps):
            t1 = time.perf_counter()
            state, metrics = run_step(state, step)
            on_metrics(step, metrics, time.perf_counter() - t1)
        say(f"done {args.steps} steps in {time.time() - t0:.1f}s")
    if losses:
        say(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
