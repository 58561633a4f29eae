"""Why a moe self-draft can miss where no verify round drops: mixtral-8x22b
at full width and `--layers` layers (random bf16 weights drawn on the
card), served on 1 slot with itself as the draft at spec_k 3, where a
round's 4 rows fit an expert's capacity of 4. Before each verify step
the draft's cache rows [0, pos) of the slot are held against the
target's, layer by layer, bit for bit; after it, each proposal against
the verify row's argmax. Prints, round by round, the first layer and
position where the two caches differ (if any) and the rejected
proposals; then whether one prompt prefilled into caches of the
engine's length and of 3 rows more (the draft cache's length before it
took the engine's; attn_chunk rows more past attn_chunk) writes the
same rows.

    python experiments/probe_moe_spec.py [--layers 8] [--requests 2]
    python experiments/probe_moe_spec.py --device cpu --reduced  # rehearsal
"""

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import ServingEngine, synthetic_trace  # noqa: E402


def _first_diff(a, b, n):
    """(layer, position) of the first of rows [0, n) where the caches
    a, b ({"k", "v"}: (L, T, Hkv, D) of one slot) differ, or None."""
    for name in ("k", "v"):
        x, y = a[name][:, :n], b[name][:, :n]
        bad = (x != y).flatten(2).any(-1)               # (L, n)
        if bad.any():
            layer, pos = (int(i) for i in bad.nonzero()[0])
            return name, layer, pos, int(bad.sum())
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_moe_spec: no card (--device cpu rehearses)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("mixtral-8x22b",
                                         reduced=args.reduced),
                              n_layers=args.layers, param_dtype="bfloat16")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    lens = (64, 512) if not args.reduced else (20, 40)
    work = synthetic_trace(cfg, 8, rng=np.random.default_rng(0),
                           len_range=lens, gen=32)[:args.requests]
    max_len = -(-max(len(it.prompt) + it.gen for it in work) // 16) * 16
    eng = ServingEngine(cfg, params, max_slots=1, max_len=max_len,
                        device=dev, draft=(cfg, params), spec_k=3)
    print(f"{cfg.name} at {args.layers} layers on "
          f"{torch.cuda.get_device_name(0) if dev.type == 'cuda' else 'cpu'};"
          f" 1 slot, k 3; target cache {eng.max_len} rows, draft cache "
          f"{eng.spec.max_len} rows; prompts "
          f"{[len(it.prompt) for it in work]}")
    draft_round, verify = eng.spec.draft_round, eng._verify_step
    seen = {}

    def drafting(tokens, pos, k_vec):
        seen["pos"] = int(pos[0])
        seen["cache"] = _first_diff(
            {k: v[:, 0] for k, v in eng.spec.cache.items()},
            {k: v[:, 0] for k, v in eng.cache.items()}, int(pos[0]))
        return draft_round(tokens, pos, k_vec)

    def verifying():
        logits = verify()
        rows = logits[0, :, :cfg.vocab].float().cpu().numpy()
        n = int(eng._ntok_h[0])
        drafts = eng._vtokens_h[0, 1:n].tolist()
        best = rows[:n].argmax(-1).tolist()
        miss = [(j, d, best[j]) for j, d in enumerate(drafts)
                if d != best[j]]
        gap = [float(np.sort(rows[j])[-1] - np.sort(rows[j])[-2])
               for j in range(n)]
        print(f"  round {eng.spec_rounds}: pos {seen['pos']}, caches "
              f"{'equal' if seen['cache'] is None else 'DIFFER ' + str(seen['cache'])}"
              f"; proposals {drafts}, verify argmax {best[:n - 1]}"
              f"{'; MISS ' + str(miss[:1]) if miss else ''}; top-2 gaps "
              f"{[round(x, 4) for x in gap]}")
        return logits
    eng.spec.draft_round, eng._verify_step = drafting, verifying
    for it in work:
        eng.submit(it.prompt, it.gen)
    rep = eng.run()
    print(f"acceptance {rep['spec_acceptance_rate']:.3f} "
          f"({rep['spec_accepted']}/{rep['spec_proposed']}), verify drops "
          f"{rep['verify_dropped']}")

    # the two prefills of one prompt, side by side
    prompt = torch.as_tensor(work[0].prompt, dtype=torch.long, device=dev)
    longer = eng.max_len + 3                 # past attn_chunk: a multiple
    if longer > cfg.attn_chunk:
        longer = eng.max_len + cfg.attn_chunk
    lengths = (eng.max_len, longer)
    subs = [M.init_cache(cfg, 1, n, dev) for n in lengths]
    for sub in subs:
        M.prefill(cfg, eng.params, {"tokens": prompt[None]}, sub)
    d = _first_diff({k: v[:, 0] for k, v in subs[0].items()},
                    {k: v[:, 0] for k, v in subs[1].items()}, len(prompt))
    print(f"a {len(prompt)}-token prefill into caches of {lengths[0]} and "
          f"{lengths[1]} rows: "
          f"{'the same rows' if d is None else 'rows differ ' + str(d)}")


if __name__ == "__main__":
    main()
