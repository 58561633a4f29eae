"""Wrapper of the naive GEMM CUDA kernel (`csrc/matmul_naive.cu`), the
paper's Listing 3: one thread for each output element, reading its row of
A and its column of B from device memory.

`matmul_naive` replaces the Pallas kernel of the same name in the JAX
package. It takes tensors on the card and launches its kernel, or raises:
the CPU path is the plain version `kernels.ref.matmul_ref`, chosen by
`kernels.ops.matmul_naive` for CPU tensors. It is the negative control of
the paper's Fig 8, slow by design, and on no model's path.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"repro_matmul_naive": [_P, _P, _P, _I, _I, _I, _L, _L, _I, _I,
                                      _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
#: The output types each input type takes: the accumulator is f32 for
#: f32 and bf16 inputs, f64 for f64.
_OUT_DTYPES = {torch.float32: (torch.float32, torch.bfloat16),
               torch.bfloat16: (torch.bfloat16, torch.float32),
               torch.float64: (torch.float64,)}
_BLOCK, _MAX_GRID_Y = 16, 65535

#: Kernel launches, counted where the wrapper launches its kernel.
LAUNCHES = {"matmul_naive": 0}


def matmul_naive(a: torch.Tensor, b: torch.Tensor, *,
                 out_dtype=None) -> torch.Tensor:
    """C = A @ B on the card, for A [M, K] and B [K, N] of one dtype
    (float32, bfloat16 or float64), each with a contiguous last dim; the
    sum over k in f32 (f64 for f64) is rounded once to out_dtype (default
    A's). Any M, N and K."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"the naive GEMM takes A and B of one dtype among "
                        f"{list(_DTYPES)}, got {a.dtype} and {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _OUT_DTYPES[a.dtype]:
        raise TypeError(f"out_dtype {out_dtype} for {a.dtype} inputs: the "
                        f"kernel writes {_OUT_DTYPES[a.dtype]}")
    for t, name in ((a, "A"), (b, "B")):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"A and B must be on one CUDA device, got "
                             f"{a.device} and {b.device}")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} needs a contiguous last dim, got "
                             f"strides {t.stride()}")
    m, k = a.shape
    n = b.shape[1]
    if -(-m // _BLOCK) > _MAX_GRID_Y:
        raise ValueError(f"M = {m} needs more than {_MAX_GRID_Y} rows of "
                         f"blocks")
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    lib = _build.load("matmul_naive", _SIGNATURES)
    err = lib.repro_matmul_naive(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, a.stride(0),
        b.stride(0), _DTYPES[a.dtype], _DTYPES[out_dtype],
        _build.stream_ptr(a.device))
    LAUNCHES["matmul_naive"] += 1
    _build.check(err, "matmul_naive")
    return c
