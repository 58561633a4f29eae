"""Hardware model for the roofline and blocking analysis of the paper's
experiment: the H100 the port runs on, and the paper's own Tesla cards,
which the benchmarks model beside the seconds the paper measured.

The port's copy of the JAX package's `core/hw.py`, with the fields the
port's modules read: shared memory a block (`smem_bytes`) takes the place
of the TPU's VMEM, f64 has its own peak (the JAX model charges a tenth of
f32 on every chip, a rule for emulating f64 on a TPU), and `lane` and
`sublane` stay so that the tile chooser gives the JAX package's answers
for the paper's cards.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    # Peak throughput, FLOP/s, by dtype.
    peak_flops_bf16: float
    peak_flops_f32: float
    peak_flops_f64: float
    # Device memory bandwidth, bytes/s.
    hbm_bw: float
    # Shared memory a block can use: the paper's sizing budget.
    smem_bytes: int
    # The JAX chooser's tile alignment: (sublane, lane) minimum tile.
    lane: int = 128

    def sublane(self, itemsize: int) -> int:
        return {4: 8, 2: 16, 1: 32}.get(itemsize, 8)

    def peak_flops(self, dtype_bytes: int) -> float:
        if dtype_bytes <= 2:
            return self.peak_flops_bf16
        if dtype_bytes == 4:
            return self.peak_flops_f32
        return self.peak_flops_f64


# NVIDIA's data sheet, H100 SXM (80 GB), dense: bf16 on the tensor cores;
# f32 on the FMA units (TF32 off); f64 on the tensor cores (DMMA, full
# f64 precision), the card's peak for f64 and the rate a library DGEMM
# approaches (the FMA units give f64 half that, 34 TFLOP/s).
H100 = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    peak_flops_f64=67e12,
    hbm_bw=3.35e12,
    smem_bytes=227 * 1024,
)

# The paper's own accelerators, used by the modeled Table-2 reproduction
# (f64 at each card's own double-precision rate).
TESLA_C2050 = ChipSpec(
    name="tesla-c2050",
    peak_flops_bf16=1.03e12,     # no bf16 in 2010; use SP rate
    peak_flops_f32=1.03e12,
    peak_flops_f64=515e9,
    hbm_bw=144e9,
    smem_bytes=48 * 1024,        # shared memory per SM
)

TESLA_C1060 = ChipSpec(
    name="tesla-c1060",
    peak_flops_bf16=0.622e12,
    peak_flops_f32=0.622e12,
    peak_flops_f64=78e9,
    hbm_bw=102e9,
    smem_bytes=16 * 1024,
)

DEFAULT_CHIP = H100


def fingerprint(chip: ChipSpec | None = None) -> str:
    """Hardware identity string: the modeled chip, the device that runs
    (the CUDA device's name, or "cpu" where there is no card), and the
    torch and CUDA versions. Safe to call without a card."""
    chip = chip or DEFAULT_CHIP
    kind = torch.cuda.get_device_name(0).replace(" ", "-") \
        if torch.cuda.is_available() else "cpu"
    return (f"{chip.name}|{kind}|torch-{torch.__version__}|"
            f"cuda-{torch.version.cuda}")
