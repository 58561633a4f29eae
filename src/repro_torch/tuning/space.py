"""Candidate spaces for the autotuner.

The port's counterpart of the JAX package's `tuning/space.py`. Where
the reference enumerates the VMEM-feasible neighbourhood of its static
tile, the port's kernels are compiled instances: the space of a GEMM is
every instance of its op and dtype (`kernels.matmul.PLANS`) whose
k-order equals the static plan's, so any candidate gives the static
plan's bits, and tuning changes which instance runs, never a bit of
what it computes. The static plan comes first, so a tuner that times
the list in turns always has it as its baseline. Instances that launch
the same kernel are dropped: where TMA cannot take an operand (a leading
dim not a multiple of 16 bytes, or K = 0), the wide tiles (WIDE and
WIDE192; the dual GEMM's WIDE and WIDE256) all run the 128-row mma.sync
tile (`csrc/matmul_tc.cuh` `launch_layout`, `launch_gated`).

The attention kernels and the SSD kernel have a space of one: their
tiles fix the bits (the flash kernels' 64-key tiles and the decode
kernels' 64-key splits set the order of the online softmax's sums, the
SSD kernel takes the whole model chunk), so no other instance may run.
"""

from __future__ import annotations

from repro_torch.core import blocking as _blocking
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.tuning.cache import (FlashBlockConfig, SSDBlockConfig,
                                      dtype_name)

# the flash kernels' tiles (`csrc/flash_attention.cu`, `core.blocking`):
# bf16 on the tensor cores 64 x 64 both ways; f32 64 query rows against 32
# keys forward, 64 backward
_FLASH = {"bfloat16": _blocking.FLASH_TILES[2],
          "float32": _blocking.FLASH_TILES[4]}
_FLASH_BWD = _blocking.FLASH_BWD_TILE


def _tma(m: int, n: int, k: int, a_km: bool, b_nk: bool) -> bool:
    """Whether TMA takes row-major operands of this shape and layout (a
    16-byte aligned base is the allocator's)."""
    lda = m if a_km else k
    ldb = k if b_nk else n
    return k > 0 and lda % 8 == 0 and ldb % 8 == 0


def _space(op: str, dtype, m: int, n: int, k: int, tma: bool,
           max_candidates: int | None) -> list:
    dt = dtype_name(dtype)
    static = _mm.static_plan(op, dt, m, k, n)
    out, seen = [], set()
    for plan in (static, *_mm.PLANS[(op, dt)]):
        if plan.k_order != static.k_order:
            continue
        launched = "mma.sync 128-row" if plan.mma.startswith("wgmma") \
            and not tma else plan.name
        if launched in seen:
            continue
        seen.add(launched)
        out.append(plan)
    if max_candidates is not None:
        out = out[:max(1, max_candidates)]
    return out


def matmul_candidates(m: int, n: int, k: int, dtype="bfloat16", *,
                      quant: bool = False, a_km: bool = False,
                      b_nk: bool = False, layouts=None,
                      max_candidates: int | None = None) -> list:
    """The instances of an (m, k) x (k, n) GEMM in a layout, or in every
    one of `layouts` ((a_km, b_nk, out dtype) triples: two wide tiles
    stay apart where TMA takes the operands of any of them); `quant`: the
    int8-weight GEMM's, on a row-major A. The static plan first."""
    if quant:
        return _space("matmul_q", dtype, m, n, k, False, max_candidates)
    layouts = layouts or ((a_km, b_nk, None),)
    return _space("matmul", dtype, m, n, k,
                  any(_tma(m, n, k, t_a, t_b) for t_a, t_b, _ in layouts),
                  max_candidates)


def gated_matmul_candidates(m: int, n: int, k: int, dtype="bfloat16", *,
                            max_candidates: int | None = None) -> list:
    """The dual GEMM's instances ((m, k) against two (k, n) row-major
    weights), the static plan first."""
    return _space("gated", dtype, m, n, k, _tma(m, n, k, False, False),
                  max_candidates)


def flash_candidates(tq: int, tk: int, d: int, dtype="bfloat16") -> list:
    """The flash forward's tile: a space of one."""
    return [_FLASH[dtype_name(dtype)]]


def flash_bwd_candidates(tq: int, tk: int, d: int, dtype="bfloat16") -> list:
    """The two-sweep backward's tile: a space of one."""
    return [_FLASH_BWD]


def flash_decode_candidates(tk: int, d: int, dtype="bfloat16") -> list:
    """The decode kernel's split of 64 keys: a space of one."""
    return [FlashBlockConfig(1, _fa.DECODE_SPLIT)]


def flash_decode_paged_candidates(page_size: int, d: int,
                                  dtype="bfloat16") -> list:
    """The paged decode kernel's split of 64 keys, whatever the page: a
    space of one."""
    return [FlashBlockConfig(1, _fa.DECODE_SPLIT)]


def ssd_candidates(chunk: int, p: int, n: int, dtype="float32") -> list:
    """The SSD kernel's execution tile, the whole model chunk and head
    dim: a space of one."""
    return [SSDBlockConfig(chunk, p)]
