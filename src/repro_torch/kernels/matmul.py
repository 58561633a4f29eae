"""Wrappers of the tiled GEMM and dual-GEMM CUDA kernels (`csrc/matmul.cu`).

`matmul_tiled` computes ``C[M,N] = epilogue(A[M,K] @ B[K,N])`` and
`gated_matmul_tiled` ``silu(A @ Wg) * (A @ Wu)``; they replace the Pallas
kernels of the same names in the JAX package. Each takes tensors on the
card and launches its kernel, or raises: the CPU path is the plain
version in `kernels.ref`, chosen by `kernels.ops` for CPU tensors.

The GEMM's B may be a [K, N] row-major tensor or the transpose view of
an [N, K] one (`w.t()`); the kernel reads either layout in place, so the
tied embedding feeds the logits GEMM without a copy. The dual GEMM takes
[K, N] row-major weights and returns A's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import EPILOGUES

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_matmul": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _I, _I, _I,
                     _I, _I, _P],
    "repro_gated_matmul": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _P],
}
_DTYPES = (torch.float32, torch.bfloat16)

#: Kernel launches, counted where each wrapper launches its kernel.
LAUNCHES = {"matmul": 0, "gated_matmul": 0}


def _lib():
    return _build.load("matmul", _SIGNATURES)


def _check_dtype(dtype: torch.dtype, what: str) -> None:
    if dtype not in _DTYPES:
        raise TypeError(f"{what}: the CUDA GEMM takes float32 or bfloat16, "
                        f"got {dtype}")


def _check_a(a: torch.Tensor) -> None:
    if a.dim() != 2 or a.stride(1) != 1:
        raise ValueError(f"A must be 2D with a contiguous last dim, got "
                         f"shape {tuple(a.shape)} strides {a.stride()}")


def _b_layout(b: torch.Tensor):
    """(b_nk, ldb) for a [K, N] operand: row-major, or the transpose view
    of a row-major [N, K] tensor."""
    if b.dim() != 2:
        raise ValueError(f"B must be 2D, got shape {tuple(b.shape)}")
    if b.stride(1) == 1:
        return 0, b.stride(0)
    if b.stride(0) == 1:
        return 1, b.stride(1)
    raise ValueError(f"B of strides {b.stride()} is neither [K, N] nor "
                     f"[N, K] row-major")


def _check_cuda(*ts) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"all operands must be on one CUDA device, got "
                             f"{[str(x.device) for x in ts]}")


def matmul_tiled(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
                 epilogue: str = "none",
                 epilogue_operand: torch.Tensor | None = None) -> torch.Tensor:
    """C = epilogue(A @ B) on the card. epilogue_operand: the (N,) bias
    for the bias* epilogues, the (M, N) residual for "residual"."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    out_dtype = out_dtype or a.dtype
    _check_dtype(a.dtype, "A")
    if b.dtype != a.dtype:
        raise TypeError(f"A is {a.dtype} but B is {b.dtype}")
    _check_dtype(out_dtype, "out_dtype")
    operands = [a, b]
    e, lde, e_bf16 = None, 0, 0
    if epilogue != "none":
        if epilogue_operand is None:
            raise ValueError(f"epilogue={epilogue!r} needs its operand")
        e = epilogue_operand
        _check_dtype(e.dtype, "epilogue operand")
        want = (m, n) if epilogue == "residual" else (n,)
        if tuple(e.shape) != want:
            raise ValueError(f"epilogue operand shape {tuple(e.shape)} != {want}")
        e = e.contiguous()
        lde = n if epilogue == "residual" else 0
        e_bf16 = int(e.dtype == torch.bfloat16)
        operands.append(e)
    _check_cuda(*operands)
    _check_a(a)
    b_nk, ldb = _b_layout(b)
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    err = _lib().repro_matmul(
        a.data_ptr(), b.data_ptr(), None if e is None else e.data_ptr(),
        c.data_ptr(), m, n, k, a.stride(0), ldb, lde, b_nk,
        int(a.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        e_bf16, EPILOGUES.index(epilogue), _build.stream_ptr(a.device))
    LAUNCHES["matmul"] += 1
    _build.check(err, "matmul_tiled")
    return c


def gated_matmul_tiled(a: torch.Tensor, w_gate: torch.Tensor,
                       w_up: torch.Tensor) -> torch.Tensor:
    """H = silu(A @ Wg) * (A @ Wu) on the card, in one pass over A."""
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
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    err = _lib().repro_gated_matmul(
        a.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), c.data_ptr(),
        m, n, k, a.stride(0), ldb, int(a.dtype == torch.bfloat16),
        _build.stream_ptr(a.device))
    LAUNCHES["gated_matmul"] += 1
    _build.check(err, "gated_matmul_tiled")
    return c
