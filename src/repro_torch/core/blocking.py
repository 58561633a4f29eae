"""The GEMM's tile and traffic model: the paper's shared-memory sizing
argument ("2 * 16 * 16 * 8 B = 4 KB <= 48 KB") and its reuse argument in
byte form, behind the modeled Table 2 and Fig 8. The GEMM part of the JAX
package's `core/blocking.py`, with shared memory a block in place of
VMEM.

For the paper's cards the chooser and the models give the JAX package's
numbers (C2050 at 4096^2 f32: a 64x128x128 tile, 0.1334 s tiled and
3.818 s naive), since it keeps the JAX chooser's (sublane, lane)
alignment. The H100 rows model the port's real kernel tile instead,
`KERNEL_TILE` (csrc/matmul.cu's wide tile, which the f32 GEMM takes at
4096^2: 128x128 outputs, a k-step of 16), not the chooser's answer. Both models count device-memory bytes only: a block's
reuse through the L1 and L2 caches is not in them.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import hw


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    bm: int
    bn: int
    bk: int

    def smem_bytes(self, itemsize: int) -> int:
        """Working set of the tiled kernel: the A and B tiles
        (double-buffered) and the f32 accumulator."""
        tiles = (self.bm * self.bk + self.bk * self.bn) * itemsize * 2
        return tiles + self.bm * self.bn * 4


#: The tile of the port's tiled f32 CUDA GEMM at the paper's size
#: (csrc/matmul.cu WB x WB, WBK; `kernels.matmul.f32_tile_plan`).
KERNEL_TILE = BlockConfig(128, 128, 16)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _round_down_pow2_mult(x: int, m: int) -> int:
    """Largest multiple of m that is <= x (at least m)."""
    return max(m, (x // m) * m)


def choose_block_config(
    m: int,
    n: int,
    k: int,
    itemsize: int = 2,
    chip: hw.ChipSpec = hw.DEFAULT_CHIP,
) -> BlockConfig:
    """Pick (bm, bn, bk) for an (m, k) x (k, n) GEMM, as the JAX chooser
    does: start from 512x512x2048-ish aligned tiles, clamp to the
    problem, then shrink (bk first, down to 512, then the larger of bm
    and bn) until the double-buffered working set fits half the chip's
    shared memory."""
    budget = chip.smem_bytes // 2
    lane = chip.lane
    sub = chip.sublane(itemsize)

    bm = min(_round_up(m, sub), 512)
    bn = min(_round_up(n, lane), 512)
    bk = min(_round_up(k, lane), 2048)
    bm = _round_down_pow2_mult(bm, sub)
    bn = _round_down_pow2_mult(bn, lane)
    bk = _round_down_pow2_mult(bk, lane)

    cfg = BlockConfig(bm, bn, bk)
    while cfg.smem_bytes(itemsize) > budget:
        if cfg.bk > 512:
            cfg = BlockConfig(cfg.bm, cfg.bn, _round_down_pow2_mult(cfg.bk // 2, lane))
        elif cfg.bm >= cfg.bn and cfg.bm > sub:
            cfg = BlockConfig(_round_down_pow2_mult(cfg.bm // 2, sub), cfg.bn, cfg.bk)
        elif cfg.bn > lane:
            cfg = BlockConfig(cfg.bm, _round_down_pow2_mult(cfg.bn // 2, lane), cfg.bk)
        elif cfg.bk > lane:
            cfg = BlockConfig(cfg.bm, cfg.bn, _round_down_pow2_mult(cfg.bk // 2, lane))
        else:
            break  # minimum tile; give up shrinking
    return cfg


def hbm_traffic_bytes(
    m: int, n: int, k: int, cfg: BlockConfig, itemsize: int
) -> int:
    """Bytes the tiled kernel moves from device memory (the Fig-8 model):
    A is streamed once per N-block column, B once per M-block row, C is
    written once. Blocking divides the traffic by the block edge."""
    n_m = math.ceil(m / cfg.bm)
    n_n = math.ceil(n / cfg.bn)
    a_bytes = m * k * itemsize * n_n
    b_bytes = k * n * itemsize * n_m
    c_bytes = m * n * itemsize
    return a_bytes + b_bytes + c_bytes


def naive_traffic_bytes(m: int, n: int, k: int, itemsize: int) -> int:
    """Traffic model of the naive kernel (paper Listing 3): each output
    element streams a full row of A and column of B with no reuse, A read
    n times and B read m times."""
    return (m * k * n + k * n * m + m * n) * itemsize


def gemm_time_model(
    m: int,
    n: int,
    k: int,
    itemsize: int,
    cfg: BlockConfig | None,
    chip: hw.ChipSpec = hw.DEFAULT_CHIP,
) -> dict:
    """Roofline time of one GEMM on `chip`: cfg=None is the naive traffic
    model. Returns both terms and which one bounds it."""
    flops = 2.0 * m * n * k
    if cfg is None:
        traffic = naive_traffic_bytes(m, n, k, itemsize)
    else:
        traffic = hbm_traffic_bytes(m, n, k, cfg, itemsize)
    t_compute = flops / chip.peak_flops(itemsize)
    t_memory = traffic / chip.hbm_bw
    return {
        "flops": flops,
        "bytes": traffic,
        "t_compute": t_compute,
        "t_memory": t_memory,
        "t_total": max(t_compute, t_memory),
        "bound": "compute" if t_compute >= t_memory else "memory",
        "arithmetic_intensity": flops / traffic,
    }
