"""Peak memory, step time and loss trajectory of the port's train step on
one card, by arch, batch, remat policy and donation.

    python experiments/probe_train_memory.py [--steps 2] [--seq 512] \
        [--runs mamba2-2.7b:4:full:donate,zamba2-1.2b:4:none:functional] \
        [--draw cpu|cuda] [--lora-draw cpu|cuda] [--plain] [--schedule 8]

Each run builds the params from `torch.Generator().manual_seed(0)` (f32,
bf16 activations; zamba2's lora_b from seed 1, as `chip_smoke.py` draws
it), or with `--draw cuda` from a CUDA generator of seed 0 (other
weights: the card's generator draws another stream; `--lora-draw cuda`
draws lora_b from a CUDA generator of seed 1 too), takes
`--steps` AdamW steps (lr 1e-3, cosine over `--schedule` steps after 2
warmup steps, clip 1.0) on `SyntheticLM(seed=0)` batches
(`make_train_step(donate=...)`), and prints each step's loss, grad norm
and wall time and the run's `max_memory_allocated`. `--plain` sends
every kernel dispatcher to its plain PyTorch version on the card, so a
trajectory can be set beside the kernels' from the same weights. A run
of 16 steps or more is held to `chip_smoke.loss_falls`, phase 8's
falling-loss gate (the mean of the last quarter of the losses below the
mean of the first), and its verdict printed. A run
that runs out of memory prints the peak it reached and the error, and
the next run starts from a freed card. Exits 2 without a card.
"""

import argparse
import dataclasses
import gc
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import GATE_STEPS, loss_falls  # noqa: E402

RUNS = ("zamba2-1.2b:4:full:donate,zamba2-1.2b:4:none:donate,"
        "zamba2-1.2b:4:full:functional,mamba2-2.7b:4:full:donate,"
        "mamba2-2.7b:4:none:donate,mamba2-2.7b:2:none:donate,"
        "mamba2-2.7b:1:none:donate,mamba2-2.7b:4:full:functional,"
        "qwen3-0.6b:4:full:functional,qwen3-0.6b:4:none:functional")


def run(torch, arch, batch, remat, donate, steps, seq, draw="cpu",
        lora_draw="cpu", schedule=8):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.training import train_loop as TL
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), remat=remat)
    opt = AdamW(lr=cosine_schedule(1e-3, 2, schedule), clip_norm=1.0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    label = f"{arch} batch {batch} x {seq} remat={remat} " \
            f"{'donated' if donate else 'functional'} {draw}-drawn" + \
            (f" (lora_b {lora_draw})" if cfg.family == "hybrid" else "")
    state = None
    try:
        params = M.init_params(
            cfg, torch.Generator(torch.device(draw)).manual_seed(0), dev)
        if cfg.family == "hybrid":
            lb = params["hybrid"]["lora_b"]
            params["hybrid"]["lora_b"] = (torch.randn(
                lb.shape, device=lora_draw, generator=torch.Generator(
                    torch.device(lora_draw)).manual_seed(1))
                * lb.shape[1] ** -0.5).to(lb)
        state = TL.TrainState(params, opt.init(params))
        del params
        held = torch.cuda.memory_allocated() - base
        step = TL.make_train_step(cfg, opt, donate=donate)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch, seed=0)
        losses = []
        for i in range(steps):
            b = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
                 for k, v in data.batch_at(i).items()}
            t0 = time.perf_counter()
            state, met = step(state, b)
            loss, gn = float(met["loss"]), float(met["grad_norm"])
            losses.append(loss)
            torch.cuda.synchronize()
            print(f"  {label}: step {i} loss {loss:.6f} grad norm {gn:.6f} "
                  f"wall {(time.perf_counter() - t0) * 1e3:.1f} ms",
                  flush=True)
        if steps >= GATE_STEPS:
            lead, trail, ok = loss_falls(losses)
            print(f"{label}: falling-loss gate: mean of the last "
                  f"{steps // 4} losses {trail:.6f}, of the first "
                  f"{steps // 4} {lead:.6f}: {'holds' if ok else 'fails'}",
                  flush=True)
        print(f"{label}: state {held / 2 ** 30:.3f} GiB, max_memory_allocated "
              f"{(torch.cuda.max_memory_allocated() - base) / 2 ** 30:.3f} "
              f"GiB above the {base / 2 ** 30:.3f} held before", flush=True)
    except torch.cuda.OutOfMemoryError as e:
        print(f"{label}: out of memory, max_memory_allocated "
              f"{(torch.cuda.max_memory_allocated() - base) / 2 ** 30:.3f} "
              f"GiB: {str(e).splitlines()[0]}", flush=True)
    finally:
        state = None
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--runs", default=RUNS)
    ap.add_argument("--draw", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--lora-draw", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--schedule", type=int, default=8)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_train_memory: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}"
          f"{'; plain versions' if args.plain else ''}", flush=True)
    if args.plain:
        from repro_torch.kernels import ops
        ops._on_card = lambda t: False
    for spec in args.runs.split(","):
        arch, batch, remat, how = spec.split(":")
        run(torch, arch, int(batch), remat, how == "donate", args.steps,
            args.seq, args.draw, args.lora_draw, args.schedule)
    return 0


if __name__ == "__main__":
    sys.exit(main())
