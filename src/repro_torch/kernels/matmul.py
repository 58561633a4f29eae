"""Wrappers of the tiled GEMM, int8-weight GEMM and dual-GEMM CUDA
kernels: bf16 activations on the tensor cores (`csrc/matmul_tc.cuh`, the
2-D entry points in `csrc/matmul_tc.cu`, the batched ones in
`csrc/matmul_tc_batched.cu`), f32 on the FMA kernels (`csrc/matmul.cu`).

`matmul_tiled` computes ``C[M,N] = epilogue(A[M,K] @ B[K,N])``,
`matmul_q_tiled` ``epilogue((A @ Wq) * scale)`` for an int8 [K, N] Wq and
its (N,) per-channel scale, and `gated_matmul_tiled`
``silu(A @ Wg) * (A @ Wu)``; they replace the Pallas kernels of the same
names in the JAX package. `matmul_batched_tiled` and
`gated_matmul_batched_tiled` are the batched forms of the GEMM and the
dual GEMM over a bank of E matrices (the MoE expert banks), one launch
for all E where the JAX package vmaps its kernels over the experts: each
expert runs the 2-D kernel's tile plan for its (M, K, N) and layout, so
its output is the 2-D kernel's on its operands, bit for bit. The batched
GEMM takes each bank in either of the 2-D GEMM's layouts (the banks'
backward reads g B^T and A^T g of every expert in place); the batched
dual GEMM row-major banks. Each takes tensors on the card and launches
its kernel, or raises: the CPU path is the plain version in
`kernels.ref`, chosen by `kernels.ops` for CPU tensors.

The GEMM's B may be a [K, N] row-major tensor or the transpose view of
an [N, K] one (`w.t()`), and its A an [M, K] row-major tensor or the
transpose view of a [K, M] one; the kernel reads either layout in place,
so the tied embedding feeds the logits GEMM and an activation feeds its
weight gradient ``aᵀ @ g`` without a copy. The dual GEMM and the int8
GEMM take a row-major A and [K, N] row-major weights.

`f32_tile_plan` picks the f32 GEMM's tile (128 x 128 from 128 rows where
that grid busies half the SMs, else 64 x 64), `tile_plan` the bf16 GEMM's,
`q_tile_plan` the int8-weight GEMM's (the 16-row mma.sync decode tile, 8 or 16 columns wide by N, else
a 128 x 64 mma.sync tile) and `gated_tile_plan` the dual GEMM's (the
decode tile with 16 columns of each weight, else the TMA + wgmma tile, 64
or 128 columns of H). Their k-order (the k-step and the split of K) is
one constant; M picks only the row tile and its instruction, and N
how wide a tile to take, so one output row has the same bits at every M.
Where a tuning cache is set (`tuning.cache.set_tuned`), each plan
function serves its winner for the shape first (`PLANS`: every compiled
instance, one k-order an op and dtype); the batched forms read the 2-D
entry for their (M, K, N). Each wrapper takes `plan=` for the tuner.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import EPILOGUES
from repro_torch.tuning import cache as _tcache

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_matmul": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _I, _I, _I,
                     _I, _I, _I, _P],
    "repro_matmul_q": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _I, _I,
                       _I, _P],
    "repro_gated_matmul": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _P],
    "repro_matmul_batched": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L, _I,
                             _I, _I, _P],
    "repro_gated_matmul_batched": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L,
                                   _L, _L, _P],
}
_TC_SIGNATURES = {
    "repro_matmul_tc": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _I, _I, _I,
                        _I, _I, _I, _P],
    "repro_matmul_q_tc": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _I, _I,
                          _I, _I, _P],
    "repro_gated_matmul_tc": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _P],
}
_TC_BATCHED_SIGNATURES = {
    "repro_matmul_batched_tc": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _L,
                                _I, _I, _I, _P],
    "repro_gated_matmul_batched_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _L,
                                      _L, _L, _I, _P],
}
_DTYPES = (torch.float32, torch.bfloat16)

#: Kernel launches, counted where each wrapper launches its kernel.
LAUNCHES = {"matmul": 0, "matmul_q": 0, "gated_matmul": 0,
            "matmul_batched": 0, "gated_matmul_batched": 0}


def _lib():
    return _build.load("matmul", _SIGNATURES)


def _tc_lib():
    return _build.load("matmul_tc", _TC_SIGNATURES)


def _tc_batched_lib():
    return _build.load("matmul_tc_batched", _TC_BATCHED_SIGNATURES)


@dataclass(frozen=True)
class TilePlan:
    """A tile of a GEMM (bf16: `csrc/matmul_tc.cuh`; f32: `csrc/matmul.cu`):
    `kernel` is the instance number the launcher takes; bm x bn outputs a
    block, bk a k-stage, `stages` of them in flight, `mma` the tensor-core
    instruction ("fma" for the f32 kernels' FMA units), `name` the
    instance's name in the tuning cache (the `Plan` enum's in
    `csrc/matmul_tc.cuh`). `k_order` fixes how each output is summed:
    the k-step and the number of parts K is split into (summed in order).
    An m16n8k16 mma.sync step and an m64nNk16 wgmma step give the same
    bits (checked on the card), so the instruction is not part of it."""
    kernel: int
    bm: int
    bn: int
    bk: int
    warps: int
    stages: int
    mma: str = "mma.sync.m16n8k16"
    k_step: int = 16
    k_split: int = 1
    name: str = ""

    @property
    def k_order(self) -> tuple:
        return self.k_step, self.k_split


_ROWS16_N8 = TilePlan(0, 16, 8, 256, 1, 4, name="ROWS16_N8")
_ROWS16_N32 = TilePlan(1, 16, 32, 128, 1, 4, name="ROWS16_N32")
_WIDE = TilePlan(2, 128, 128, 64, 12, 4, mma="wgmma.m64n128k16", name="WIDE")
_WIDE192 = TilePlan(3, 128, 192, 64, 12, 4, mma="wgmma.m64n192k16",
                    name="WIDE192")
_SMS = 132                      # H100 SXM: one wide block an SM
# the f32 GEMM's FMA tiles (`csrc/matmul.cu`), which sum one k at a time;
# the f32 int8-weight and dual GEMMs have the 64 x 64 one alone
_F32_64 = TilePlan(0, 64, 64, 32, 8, 1, mma="fma", k_step=1, name="F32_64")
_F32_WIDE = TilePlan(1, 128, 128, 16, 8, 2, mma="fma", k_step=1,
                     name="F32_128")
# the int8-weight GEMM's decode tiles by width, and its 128 x 64 tile
_Q_ROWS16 = {8: TilePlan(0, 16, 8, 256, 1, 4, name="ROWS16_N8"),
             16: TilePlan(4, 16, 16, 256, 1, 4, name="ROWS16_N16")}
_Q_NARROW = TilePlan(2, 128, 64, 64, 4, 3, name="WIDE")
# the dual GEMM's (bn: columns of H a block, each from Wg and Wu)
_GATED_ROWS16 = TilePlan(4, 16, 16, 128, 1, 4, name="ROWS16_N16")
_GATED_WIDE = {64: TilePlan(2, 128, 64, 64, 12, 4, mma="wgmma.m64n128k16",
                            name="WIDE"),
               128: TilePlan(5, 128, 128, 64, 12, 4, mma="wgmma.m64n256k16",
                             name="WIDE256")}

#: Every compiled instance of a GEMM, by (op, dtype): the bf16 GEMM's
#: four, the f32 GEMM's two tiles, the int8-weight GEMM's three and the
#: dual GEMM's three (each f32 form one). The instances of an op and dtype
#: sum each output in one k-order, so any of them gives the same bits:
#: the tuner picks among them (`tuning.space`).
PLANS = {
    ("matmul", "bfloat16"): (_ROWS16_N8, _ROWS16_N32, _WIDE, _WIDE192),
    ("matmul", "float32"): (_F32_64, _F32_WIDE),
    ("matmul_q", "bfloat16"): (_Q_ROWS16[8], _Q_ROWS16[16], _Q_NARROW),
    ("matmul_q", "float32"): (_F32_64,),
    ("gated", "bfloat16"): (_GATED_ROWS16, _GATED_WIDE[64], _GATED_WIDE[128]),
    ("gated", "float32"): (_F32_64,),
}


def _instance(op: str, dtype: str, name: str) -> TilePlan:
    """The compiled instance `name` of `op` in `dtype`; raises if there is
    none (a tuning cache's entry must name one)."""
    for plan in PLANS[(op, dtype)]:
        if plan.name == name:
            return plan
    raise ValueError(f"{op} in {dtype} has no instance {name!r}; its "
                     f"instances: {[p.name for p in PLANS[(op, dtype)]]}")


def _served(op: str, dtype: str, m: int, k: int, n: int,
            epilogue: str = "none") -> TilePlan | None:
    """The instance the tuned cache (`tuning.cache.set_tuned`) names for
    this GEMM, or None where no cache is set or the shape misses. An
    entry that names no instance of the op raises: a cached instance
    never gives way to the static plan."""
    cache = _tcache.tuned_cache()
    if cache is None:
        return None
    if op == "gated":
        name = cache.get_gated(m, n, k, dtype)
    elif op == "matmul_q":
        name = cache.get_matmul_q(m, n, k, dtype, epilogue)
    else:
        name = cache.get_matmul(m, n, k, dtype, epilogue)
    return None if name is None else _instance(op, dtype, name)


def static_plan(op: str, dtype: str, m: int, k: int, n: int) -> TilePlan:
    """The plan the fixed rules below pick, whatever the tuning cache."""
    if dtype == "float32":
        return _f32_rule(m, n) if op == "matmul" else _F32_64
    return {"matmul": _tile_rule, "matmul_q": _q_rule,
            "gated": _gated_rule}[op](m, n)


def _check_plan(plan: TilePlan, op: str, dtype: str) -> None:
    if plan not in PLANS[(op, dtype)]:
        raise ValueError(f"{plan} is not an instance of {op} in {dtype}; "
                         f"its instances: "
                         f"{[p.name for p in PLANS[(op, dtype)]]}")


def _f32_rule(m: int, n: int) -> TilePlan:
    wide_blocks = -(-m // 128) * -(-n // 128)
    return _F32_WIDE if m >= 128 and wide_blocks >= _SMS // 2 else _F32_64


def f32_tile_plan(m: int, k: int, n: int,
                  epilogue: str = "none") -> TilePlan:
    """The f32 GEMM's tile: 128 x 128 outputs a block (8 x 8 a thread,
    two blocks an SM) where M fills its rows and its grid has a block for
    half the SMs at least, else 64 x 64 (4 x 4 a thread), which skips the
    multiply-adds of rows past M (decode) and whose four times as many
    blocks keep more SMs busy at a few hundred rows. On an H100 at
    K = 1024 the wide tile is 25% faster at 96 wide blocks, but at 48 it
    gains 5% with a bias and loses as much with a gelu or silu flush (64
    outputs a thread), `experiments/probe_fma_kernels.py`. Both tiles sum
    each output one k at a time in ascending order, so the plan changes
    no bits: one k-order in every plan, whatever (m, k, n) and layout.
    A tuned cache's winner for (m, k, n, epilogue) comes first."""
    return _served("matmul", "float32", m, k, n, epilogue) \
        or _f32_rule(m, n)


def _tile_rule(m: int, n: int) -> TilePlan:
    if m <= 16:
        return _ROWS16_N32 if n >= 32768 else _ROWS16_N8

    def cost(bn):                # waves of blocks x the work of one
        return -(-(-(-m // 128) * -(-n // bn)) // _SMS) * bn
    return _WIDE192 if cost(192) < cost(128) else _WIDE


def tile_plan(m: int, k: int, n: int, a_km: bool, b_nk: bool,
              epilogue: str = "none") -> TilePlan:
    """The bf16 GEMM's tile for an (m, k, n) product in a layout. The
    k-order is the same in every plan, whatever (m, k, n) and layout;
    m picks the row tile: 16 rows for decode (m <= 16), with 8 columns a
    block (32 for the logits' width, to cut the block count), else the
    128-row TMA and wgmma tile, 192 columns wide where its waves of
    blocks take less time than 128's, else 128 (the launcher gives an
    operand TMA cannot take to a 128 x 64 mma.sync tile). The int8-weight
    and dual GEMMs take the same decode tile and k-order from
    `q_tile_plan` and `gated_tile_plan`. A tuned cache's winner for
    (m, k, n, epilogue), read whatever the layout, comes first."""
    return _served("matmul", "bfloat16", m, k, n, epilogue) \
        or _tile_rule(m, n)


def _q_rule(m: int, n: int) -> TilePlan:
    if m <= 16:
        return _Q_ROWS16[8 if n <= 1024 else 16]
    return _Q_NARROW


def q_tile_plan(m: int, k: int, n: int, epilogue: str = "none") -> TilePlan:
    """The int8-weight GEMM's tile: for decode (m <= 16) the 16-row
    mma.sync tile, 8 int8 columns a block up to N = 1024 and 16 above (of
    8, 16 and 32, the fastest at N = 1024 and 3072 on an H100, `PERF.md`;
    the width changes only which columns share a block); else the
    128 x 64 mma.sync tile. One k-order in every plan, as `tile_plan`'s;
    a tuned cache's winner comes first."""
    return _served("matmul_q", "bfloat16", m, k, n, epilogue) \
        or _q_rule(m, n)


def _gated_rule(m: int, n: int) -> TilePlan:
    if m <= 16:
        return _GATED_ROWS16
    return _GATED_WIDE[128 if -(-m // 128) * -(-n // 128) >= _SMS else 64]


def gated_tile_plan(m: int, k: int, n: int) -> TilePlan:
    """The dual GEMM's tile: for decode (m <= 16) the 16-row mma.sync tile
    with 16 columns of Wg and the same 16 of Wu; else the TMA + wgmma tile:
    128 columns of each in one m64n256k16 step (128 x 128 of H a block)
    where that grid fills every SM at least once, else 64 of each in one
    m64n128k16 step (an operand TMA cannot take, or K = 0, goes to a
    128-row mma.sync tile). One k-order in every plan, as `tile_plan`'s;
    a tuned cache's winner comes first."""
    return _served("gated", "bfloat16", m, k, n) or _gated_rule(m, n)


def _check_dtype(dtype: torch.dtype, what: str) -> None:
    if dtype not in _DTYPES:
        raise TypeError(f"{what}: the CUDA GEMM takes float32 or bfloat16, "
                        f"got {dtype}")


def _check_a(a: torch.Tensor) -> None:
    if a.dim() != 2 or a.stride(1) != 1:
        raise ValueError(f"A must be 2D with a contiguous last dim, got "
                         f"shape {tuple(a.shape)} strides {a.stride()}")


def _layout(x: torch.Tensor, name: str, dims: str):
    """(transposed, leading dim) for a 2D operand of dims "RC": row-major
    [R, C], or the transpose view of a row-major [C, R] tensor."""
    if x.dim() != 2:
        raise ValueError(f"{name} must be 2D, got shape {tuple(x.shape)}")
    if x.stride(1) == 1:
        return 0, x.stride(0)
    if x.stride(0) == 1:
        return 1, x.stride(1)
    raise ValueError(f"{name} of strides {x.stride()} is neither "
                     f"[{dims[0]}, {dims[1]}] nor [{dims[1]}, {dims[0]}] "
                     f"row-major")


def _check_cuda(*ts) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"all operands must be on one CUDA device, got "
                             f"{[str(x.device) for x in ts]}")


def _epilogue_args(epilogue, epilogue_operand, m, n):
    """(operand or None, its row stride, is-bf16) for the kernel's flush."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue == "none":
        return None, 0, 0
    if epilogue_operand is None:
        raise ValueError(f"epilogue={epilogue!r} needs its operand")
    e = epilogue_operand
    _check_dtype(e.dtype, "epilogue operand")
    want = (m, n) if epilogue == "residual" else (n,)
    if tuple(e.shape) != want:
        raise ValueError(f"epilogue operand shape {tuple(e.shape)} != {want}")
    return (e.contiguous(), n if epilogue == "residual" else 0,
            int(e.dtype == torch.bfloat16))


def matmul_tiled(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
                 epilogue: str = "none",
                 epilogue_operand: torch.Tensor | None = None,
                 plan: TilePlan | None = None) -> torch.Tensor:
    """C = epilogue(A @ B) on the card. epilogue_operand: the (N,) bias
    for the bias* epilogues, the (M, N) residual for "residual". plan:
    the instance to launch (the tuner's; it must be one of `PLANS` for
    the op and dtype), else `tile_plan` / `f32_tile_plan`'s."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    out_dtype = out_dtype or a.dtype
    _check_dtype(a.dtype, "A")
    if b.dtype != a.dtype:
        raise TypeError(f"A is {a.dtype} but B is {b.dtype}")
    _check_dtype(out_dtype, "out_dtype")
    e, lde, e_bf16 = _epilogue_args(epilogue, epilogue_operand, m, n)
    _check_cuda(a, b, *([] if e is None else [e]))
    a_km, lda = _layout(a, "A", "MK")
    b_nk, ldb = _layout(b, "B", "KN")
    bf16 = a.dtype == torch.bfloat16
    if plan is None:
        plan = tile_plan(m, k, n, bool(a_km), bool(b_nk), epilogue) if bf16 \
            else f32_tile_plan(m, k, n, epilogue)
    else:
        _check_plan(plan, "matmul", "bfloat16" if bf16 else "float32")
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    operands = (a.data_ptr(), b.data_ptr(),
                None if e is None else e.data_ptr(), c.data_ptr(), m, n, k,
                lda, ldb, lde, a_km, b_nk)
    if bf16:                             # the tensor cores
        err = _tc_lib().repro_matmul_tc(
            *operands, int(out_dtype == torch.bfloat16), e_bf16,
            EPILOGUES.index(epilogue), plan.kernel,
            _build.stream_ptr(a.device))
    else:                                # f32: the FMA kernels
        err = _lib().repro_matmul(
            *operands, int(out_dtype == torch.bfloat16), e_bf16,
            EPILOGUES.index(epilogue), plan.kernel,
            _build.stream_ptr(a.device))
    LAUNCHES["matmul"] += 1
    _build.check(err, "matmul_tiled")
    return c


def matmul_q_tiled(a: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *,
                   out_dtype=None, epilogue: str = "none",
                   epilogue_operand: torch.Tensor | None = None,
                   plan: TilePlan | None = None) -> torch.Tensor:
    """C = epilogue((A @ Wq) * scale) on the card. wq: int8 [K, N]
    row-major; scale: (N,) or (1, N) float32, applied to the f32
    accumulator before the epilogue. plan: as `matmul_tiled`'s
    (`q_tile_plan`'s by default; f32 A has one instance)."""
    m, k = a.shape
    if wq.dim() != 2 or wq.shape[0] != k:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(wq.shape)}")
    n = wq.shape[1]
    out_dtype = out_dtype or a.dtype
    _check_dtype(a.dtype, "A")
    _check_dtype(out_dtype, "out_dtype")
    if wq.dtype != torch.int8:
        raise TypeError(f"matmul_q takes an int8 weight, got {wq.dtype}")
    if wq.stride(1) != 1:
        raise ValueError(f"the int8 weight must be [K, N] row-major, got "
                         f"strides {wq.stride()}")
    if scale.dtype != torch.float32 or scale.numel() != n:
        raise ValueError(f"scale must be ({n},) float32, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    s = scale.reshape(n).contiguous()
    e, lde, e_bf16 = _epilogue_args(epilogue, epilogue_operand, m, n)
    _check_cuda(a, wq, s, *([] if e is None else [e]))
    _check_a(a)
    bf16 = a.dtype == torch.bfloat16
    if plan is None:
        plan = q_tile_plan(m, k, n, epilogue) if bf16 else _F32_64
    else:
        _check_plan(plan, "matmul_q", "bfloat16" if bf16 else "float32")
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    operands = (a.data_ptr(), wq.data_ptr(), s.data_ptr(),
                None if e is None else e.data_ptr(), c.data_ptr(), m, n, k,
                a.stride(0), wq.stride(0), lde,
                int(out_dtype == torch.bfloat16), e_bf16,
                EPILOGUES.index(epilogue))
    if bf16:                             # the tensor cores
        err = _tc_lib().repro_matmul_q_tc(
            *operands, plan.kernel, _build.stream_ptr(a.device))
    else:                                # f32: the FMA kernel
        err = _lib().repro_matmul_q(*operands, _build.stream_ptr(a.device))
    LAUNCHES["matmul_q"] += 1
    _build.check(err, "matmul_q_tiled")
    return c


def gated_matmul_tiled(a: torch.Tensor, w_gate: torch.Tensor,
                       w_up: torch.Tensor, *,
                       plan: TilePlan | None = None) -> torch.Tensor:
    """H = silu(A @ Wg) * (A @ Wu) on the card, in one pass over A.
    plan: as `matmul_tiled`'s (`gated_tile_plan`'s by default; f32 has
    one instance)."""
    m, k = a.shape
    if w_gate.shape != w_up.shape or w_gate.shape[0] != k:
        raise ValueError(f"shapes {tuple(a.shape)}, {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}")
    n = w_gate.shape[1]
    _check_dtype(a.dtype, "A")
    if w_gate.dtype != a.dtype or w_up.dtype != a.dtype:
        raise TypeError(f"A is {a.dtype}, weights {w_gate.dtype}/{w_up.dtype}")
    _check_cuda(a, w_gate, w_up)
    _check_a(a)
    ldb = w_gate.stride(0)
    for w in (w_gate, w_up):
        if w.stride(1) != 1 or w.stride(0) != ldb:
            raise ValueError("w_gate and w_up must be [K, N] row-major with "
                             "one row stride")
    bf16 = a.dtype == torch.bfloat16
    if plan is None:
        plan = gated_tile_plan(m, k, n) if bf16 else _F32_64
    else:
        _check_plan(plan, "gated", "bfloat16" if bf16 else "float32")
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    operands = (a.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                c.data_ptr(), m, n, k, a.stride(0), ldb)
    if bf16:                             # the tensor cores
        err = _tc_lib().repro_gated_matmul_tc(
            *operands, plan.kernel, _build.stream_ptr(a.device))
    else:                                # f32: the FMA kernel
        err = _lib().repro_gated_matmul(*operands, _build.stream_ptr(a.device))
    LAUNCHES["gated_matmul"] += 1
    _build.check(err, "gated_matmul_tiled")
    return c


#: The most experts one batched launch takes (blockIdx.z).
MAX_EXPERTS = 65535


def _check_bank(x: torch.Tensor, name: str, e: int,
                transposed: bool = False):
    """x must be an (e, R, C) bank of matrices one stride apart, each
    row-major or (`transposed`) the transpose view of a row-major (C, R):
    returns its (transposed, leading dim), as `_layout` for one matrix."""
    if x.dim() != 3 or x.shape[0] != e:
        raise ValueError(f"{name} must be a bank of {e} matrices (E, R, C), "
                         f"got shape {tuple(x.shape)}")
    if x.stride(2) == 1:
        return 0, x.stride(1)
    if transposed and x.stride(1) == 1:
        return 1, x.stride(2)
    raise ValueError(f"{name}'s matrices must be row-major"
                     f"{' or transpose views' if transposed else ''}, got "
                     f"strides {x.stride()}")


def _check_batch(a: torch.Tensor, ws, what: str, transposed=False):
    """(E, each bank's (transposed, leading dim)) of A and the banks `ws`,
    ((name, bank), ...), one dtype on one card."""
    e = a.shape[0] if a.dim() == 3 else -1
    layouts = [_check_bank(x, name, e, transposed)
               for name, x in (("A", a), *ws)]
    if e > MAX_EXPERTS:
        raise ValueError(f"{what}: at most {MAX_EXPERTS} experts a launch, "
                         f"got {e}")
    _check_dtype(a.dtype, "A")
    for name, w in ws:
        if w.dtype != a.dtype:
            raise TypeError(f"A is {a.dtype} but {name} is {w.dtype}")
    _check_cuda(a, *(w for _, w in ws))
    return e, layouts


def matmul_batched_tiled(a: torch.Tensor, b: torch.Tensor, *,
                         plan: TilePlan | None = None) -> torch.Tensor:
    """C[e] = A[e] @ B[e] on the card, in A's dtype, for a bank A (E, M, K)
    and a bank B (E, K, N): one launch, an expert a blockIdx.z, each on
    the plan `tile_plan` (bf16) or `f32_tile_plan` (f32) picks for
    (M, K, N) in its layout (a tuned cache's 2-D entry for (M, K, N)
    included), or on `plan`. Each bank may be row-major or, per expert,
    the transpose view of a row-major (E, K, M) or (E, N, K) one
    (`x.transpose(1, 2)`), read in place."""
    e, ((a_km, lda), (b_nk, ldb)) = _check_batch(
        a, (("B", b),), "matmul_batched_tiled", transposed=True)
    _, m, k = a.shape
    if b.shape[1] != k:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    n = b.shape[2]
    bf16 = a.dtype == torch.bfloat16
    if plan is None:
        plan = tile_plan(m, k, n, bool(a_km), bool(b_nk)) if bf16 \
            else f32_tile_plan(m, k, n)
    else:
        _check_plan(plan, "matmul", "bfloat16" if bf16 else "float32")
    c = torch.empty((e, m, n), dtype=a.dtype, device=a.device)
    operands = (a.data_ptr(), b.data_ptr(), c.data_ptr(), e, m, n, k,
                lda, ldb, a.stride(0), b.stride(0), a_km, b_nk)
    if bf16:                             # the tensor cores
        err = _tc_batched_lib().repro_matmul_batched_tc(
            *operands, plan.kernel, _build.stream_ptr(a.device))
    else:                                # f32: the FMA kernels
        err = _lib().repro_matmul_batched(
            *operands, plan.kernel, _build.stream_ptr(a.device))
    LAUNCHES["matmul_batched"] += 1
    _build.check(err, "matmul_batched_tiled")
    return c


def gated_matmul_batched_tiled(a: torch.Tensor, w_gate: torch.Tensor,
                               w_up: torch.Tensor, *,
                               plan: TilePlan | None = None) -> torch.Tensor:
    """H[e] = silu(A[e] @ Wg[e]) * (A[e] @ Wu[e]) on the card, in A's dtype,
    for a bank A (E, M, K) and banks Wg, Wu (E, K, N) of one layout: one
    launch, an expert a blockIdx.z, each on the plan `gated_tile_plan`
    picks for (M, K, N), or on `plan` (bf16; f32 takes the FMA kernel)."""
    e, _ = _check_batch(a, (("w_gate", w_gate), ("w_up", w_up)),
                     "gated_matmul_batched_tiled")
    _, m, k = a.shape
    if w_gate.shape != w_up.shape or w_gate.shape[1] != k:
        raise ValueError(f"shapes {tuple(a.shape)}, {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}")
    if w_gate.stride() != w_up.stride():
        raise ValueError(f"w_gate and w_up must share their strides, got "
                         f"{w_gate.stride()} and {w_up.stride()}")
    n = w_gate.shape[2]
    bf16 = a.dtype == torch.bfloat16
    if plan is None:
        plan = gated_tile_plan(m, k, n) if bf16 else _F32_64
    else:
        _check_plan(plan, "gated", "bfloat16" if bf16 else "float32")
    c = torch.empty((e, m, n), dtype=a.dtype, device=a.device)
    operands = (a.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                c.data_ptr(), e, m, n, k, a.stride(1), w_gate.stride(1),
                a.stride(0), w_gate.stride(0))
    if bf16:                             # the tensor cores
        err = _tc_batched_lib().repro_gated_matmul_batched_tc(
            *operands, plan.kernel, _build.stream_ptr(a.device))
    else:                                # f32: the FMA kernel
        err = _lib().repro_gated_matmul_batched(
            *operands, _build.stream_ptr(a.device))
    LAUNCHES["gated_matmul_batched"] += 1
    _build.check(err, "gated_matmul_batched_tiled")
    return c
