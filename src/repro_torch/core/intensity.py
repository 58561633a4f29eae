"""Arithmetic-intensity classification, the paper's claim C3 generalized.

The paper observes that matrix addition (AI ~ 1/12 flop/byte for f32)
gains nothing from the accelerator while GEMM (AI ~ n/6) gains 1000x.
This module turns that observation into a classifier used by the
benchmarks (the port's copy of the JAX package's `core/intensity.py`).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import hw


@dataclasses.dataclass(frozen=True)
class OpProfile:
    name: str
    flops: float
    hbm_bytes: float

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)


def machine_balance(chip: hw.ChipSpec = hw.DEFAULT_CHIP, itemsize: int = 2) -> float:
    """FLOPs/byte the chip can sustain; ops below this are memory-bound."""
    return chip.peak_flops(itemsize) / chip.hbm_bw


def classify(profile: OpProfile, chip: hw.ChipSpec = hw.DEFAULT_CHIP,
             itemsize: int = 2) -> dict:
    balance = machine_balance(chip, itemsize)
    ai = profile.arithmetic_intensity
    t_compute = profile.flops / chip.peak_flops(itemsize)
    t_memory = profile.hbm_bytes / chip.hbm_bw
    return {
        "name": profile.name,
        "arithmetic_intensity": ai,
        "machine_balance": balance,
        "bound": "compute" if ai >= balance else "memory",
        "t_compute": t_compute,
        "t_memory": t_memory,
        "attainable_flops": min(chip.peak_flops(itemsize), ai * chip.hbm_bw),
        "roofline_fraction": min(1.0, ai / balance),
    }


def matmul_profile(m: int, n: int, k: int, itemsize: int) -> OpProfile:
    return OpProfile(
        name=f"matmul_{m}x{k}x{n}",
        flops=2.0 * m * n * k,
        hbm_bytes=float((m * k + k * n + m * n) * itemsize),
    )


def add_profile(m: int, n: int, itemsize: int) -> OpProfile:
    """C = A + B: one flop per element, three arrays of traffic (Fig. 9)."""
    return OpProfile(
        name=f"add_{m}x{n}",
        flops=float(m * n),
        hbm_bytes=float(3 * m * n * itemsize),
    )
