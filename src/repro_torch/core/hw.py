"""Hardware model for the roofline and blocking analysis of the paper's
experiment: the H100 the port runs on, and the paper's own Tesla cards,
which the benchmarks model beside the seconds the paper measured.

The port's copy of the JAX package's `core/hw.py`, with the fields the
port's modules read: shared memory a block (`smem_bytes`) takes the place
of the TPU's VMEM, f64 has its own peak (the JAX model charges a tenth of
f32 on every chip, a rule for emulating f64 on a TPU), and `lane` and
`sublane` stay so that the tile chooser gives the JAX package's answers
for the paper's cards. The roofline (`roofline.analysis`) and the traffic
models (`core.blocking`) read the rest: device memory, the L2 a wave of
blocks shares, the TF32 tensor-core peak, the SM count and compute
capability, and NVLink (per
link and direction, and the links a card has: the counterparts of the
reference's `ici_link_bw` and `ici_links`).
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
    # Device memory and the L2 cache, bytes.
    hbm_bytes: int = 0
    l2_bytes: int = 0
    # Peak of f32 products on the tensor cores as TF32 (0: none).
    peak_flops_tf32: float = 0.0
    # Streaming multiprocessors: the blocks of one wave at one block an SM.
    sm_count: int = 0
    # NVLink: bandwidth a link in one direction, bytes/s, and links a card.
    nvlink_bw: float = 0.0
    nvlink_links: int = 0
    # Compute capability, major * 10 + minor. The port's kernels are built
    # for sm_90a: on a chip of 90 or more a tile is the plan they run.
    sm_arch: int = 0

    @property
    def runs_port_kernels(self) -> bool:
        return self.sm_arch >= 90

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
# approaches (the FMA units give f64 half that, 34 TFLOP/s); TF32 on the
# tensor cores; 80 GB of HBM3, a 50 MB L2, 132 SMs; NVLink 4, 18 links of
# 50 GB/s both ways together (900 GB/s a card), 25 GB/s each way.
H100 = ChipSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    peak_flops_f32=67e12,
    peak_flops_f64=67e12,
    hbm_bw=3.35e12,
    smem_bytes=227 * 1024,
    hbm_bytes=80 * 10 ** 9,
    l2_bytes=50 * 1024 ** 2,
    peak_flops_tf32=495e12,
    sm_count=132,
    nvlink_bw=25e9,
    nvlink_links=18,
    sm_arch=90,
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
    hbm_bytes=3 * 1024**3,
    l2_bytes=768 * 1024,
    sm_count=14,
    sm_arch=20,
)

TESLA_C1060 = ChipSpec(
    name="tesla-c1060",
    peak_flops_bf16=0.622e12,
    peak_flops_f32=0.622e12,
    peak_flops_f64=78e9,
    hbm_bw=102e9,
    smem_bytes=16 * 1024,
    hbm_bytes=4 * 1024**3,
    sm_count=30,
    sm_arch=13,
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
