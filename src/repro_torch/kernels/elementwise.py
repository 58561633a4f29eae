"""Wrappers of the elementwise CUDA kernels (`csrc/elementwise.cu`):
`binary_op` computes ``C = A op B`` for op in add, sub and mul, and `axpy`
``alpha * x + y``; they replace the Pallas kernels of the same names in
the JAX package (the paper's Fig 9). Each takes tensors on the card and
launches its kernel, or raises: the CPU path is the plain version in
`kernels.ref`, chosen by `kernels.ops` for CPU tensors.

The kernels take their operands flat: any shape, each operand contiguous,
float32, bfloat16 or float64. The result is bit for bit the plain
version's (one correctly rounded op; axpy rounds alpha * x, then the
sum).
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from repro_torch.kernels import _build

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_double
_SIGNATURES = {
    "repro_binary_op": [_P, _P, _P, _L, _I, _I, _I, _P],
    "repro_axpy": [_P, _D, _P, _P, _P, _L, _I, _I, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
OPS = ("add", "sub", "mul")

#: Kernel launches, counted where each wrapper launches its kernel.
LAUNCHES = {"binary_op": 0, "axpy": 0}


def _lib():
    return _build.load("elementwise", _SIGNATURES)


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.shape != y.shape:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(y.shape)} "
                         f"differ")
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise TypeError(f"the elementwise kernels take operands of one dtype "
                        f"among {list(_DTYPES)}, got {x.dtype} and {y.dtype}")
    for t in (x, y):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"operands must be on one CUDA device, got "
                             f"{x.device} and {y.device}")
        if not t.is_contiguous():
            raise ValueError(f"the elementwise kernels take contiguous "
                             f"operands, got strides {t.stride()}")


def _vec(*ts) -> int:
    """1 where every operand starts on a 16-byte boundary: the kernel then
    moves 16 bytes a load."""
    return int(all(t.data_ptr() % 16 == 0 for t in ts))


def binary_op(a: torch.Tensor, b: torch.Tensor, op: str = "add") -> torch.Tensor:
    """C = A op B on the card, in A's dtype, op in add, sub and mul."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {OPS}")
    _check(a, b)
    c = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    err = _lib().repro_binary_op(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), a.numel(), _DTYPES[a.dtype],
        OPS.index(op), _vec(a, b, c), _build.stream_ptr(a.device))
    LAUNCHES["binary_op"] += 1
    _build.check(err, f"binary_op {op}")
    return c


def axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """alpha * x + y on the card, in x's dtype. alpha: a real number, or a
    one-element tensor on x's device, cast to x's dtype first; the kernel
    reads a tensor alpha through its pointer, so no value crosses to the
    host."""
    _check(x, y)
    if isinstance(alpha, torch.Tensor):
        if alpha.numel() != 1 or alpha.device != x.device:
            raise ValueError(f"alpha must be a number or a one-element "
                             f"tensor on {x.device}, got shape "
                             f"{tuple(alpha.shape)} on {alpha.device}")
        alpha_t = alpha.reshape(1).to(x.dtype)
        alpha_p, alpha_v = alpha_t.data_ptr(), 0.0
    elif isinstance(alpha, numbers.Real):
        alpha_p, alpha_v = None, float(alpha)
    else:
        raise TypeError(f"alpha must be a real number or a tensor, got "
                        f"{type(alpha).__name__}")
    c = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    err = _lib().repro_axpy(
        alpha_p, alpha_v, x.data_ptr(), y.data_ptr(), c.data_ptr(), x.numel(),
        _DTYPES[x.dtype], _vec(x, y, c), _build.stream_ptr(x.device))
    LAUNCHES["axpy"] += 1
    _build.check(err, "axpy")
    return c
