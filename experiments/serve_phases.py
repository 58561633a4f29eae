"""Run the serving phases of a checkout's `chip_smoke.py` on one card.

    python experiments/serve_phases.py [--root DIR]

Runs phases 1-2 (the card, the build) and the serving phases 4, 5 and 7
(qwen3-0.6b dense and paged, the int8 paged path, mamba2-2.7b) of the
`chip_smoke.py` in DIR, against the `src/repro_torch` beside it, and
prints what they print: decode step p50, time to first token, memory,
traces. DIR defaults to this checkout; a parent commit unpacked with
`git archive` into a git-ignored directory (`build/parent`) runs the same
way, so two versions of the serving engine can be timed in turns in one
call to the card. Exits 2 without a card; a gate of those phases that
fails raises.
"""

import argparse
import importlib.util
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose chip_smoke.py and src/ to run")
    root = Path(ap.parse_args(argv).root).resolve()
    import torch
    if not torch.cuda.is_available():
        print("serve_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    s = smoke.Smoke(torch)
    print(f"serve_phases: {root}")
    for phase in (s.phase_card, s.phase_build, s.phase_serve, s.phase_trace,
                  s.phase_batching, s.phase_paged, s.phase_mamba):
        phase()
    return 0


if __name__ == "__main__":
    sys.exit(main())
