"""int8 quantization of weights and KV rows, as the JAX package does it
(`repro/core/precision.py`): per-channel symmetric int8 with
``scale = amax / 127`` over the contraction axis, round half to even,
clipped to [-127, 127]. On float32 input the (q, scale) pair is the
JAX package's bit for bit. Also the paper's complex-float GEMM through
real GEMMs, and the FLOP count of a GEMM by dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

#: Quantization modes a QuantSpec can describe (the engine's `quant`
#: adds "off": no spec at all).
QUANT_MODES = ("int8",)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """mode: the storage format. axis: the contraction axis reduced for
    the per-channel amax; -2 gives a (K, N) weight one scale per output
    channel, and a stacked (L, K, N) weight (L, 1, N) scales."""
    mode: str = "int8"
    axis: int = -2

    def __post_init__(self):
        if self.mode not in QUANT_MODES:
            raise ValueError(f"unknown quantization mode {self.mode!r}; "
                             f"expected one of {QUANT_MODES}")


def quantize_int8(w: torch.Tensor, axis: int = -2):
    """(q, scale): q = round(w / scale) clipped to [-127, 127] as int8,
    scale = amax / 127 in float32 over `axis` (keepdims), and 1 where a
    channel is all zeros."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax, torch.full_like(amax, 127.0)) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize(w: torch.Tensor, spec: QuantSpec):
    """Quantize `w` per `spec` -> (q, scale)."""
    if spec.mode == "int8":
        return quantize_int8(w, axis=spec.axis)
    raise ValueError(f"unknown quantization mode {spec.mode!r}; "
                     f"expected one of {QUANT_MODES}")


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """q * scale in scale's dtype."""
    return q.to(scale.dtype) * scale


#: KV rows contract over head_dim (the last axis): one scale per
#: (position, head).
KV_QUANT_SPEC = QuantSpec(mode="int8", axis=-1)


def quantize_kv(x: torch.Tensor):
    """int8 K/V rows for int8 page pools: (q, scale) with the keepdims
    axis squeezed off the scale, which the pool keeps as its own
    (..., position, head) plane."""
    q, scale = quantize(x, KV_QUANT_SPEC)
    return q, scale.squeeze(-1)


def complex_matmul(a: torch.Tensor, b: torch.Tensor,
                   real_matmul: Callable[[torch.Tensor, torch.Tensor],
                                         torch.Tensor],
                   algorithm: str = "gauss3") -> torch.Tensor:
    """Complex GEMM through real GEMMs (the paper's complex-float column):
    "naive4" takes four real products, "gauss3" three (Gauss's trick).
    `real_matmul` is any real GEMM, the tiled or the naive kernel's
    dispatcher; the real and imaginary parts reach it contiguous, since
    `torch.real`/`torch.imag` are strided views. The sums between the
    products are plain PyTorch, as the JAX package leaves them to XLA."""
    ar, ai = a.real.contiguous(), a.imag.contiguous()
    br, bi = b.real.contiguous(), b.imag.contiguous()
    if algorithm == "naive4":
        re = real_matmul(ar, br) - real_matmul(ai, bi)
        im = real_matmul(ar, bi) + real_matmul(ai, br)
    elif algorithm == "gauss3":
        t1 = real_matmul(ar, br)
        t2 = real_matmul(ai, bi)
        t3 = real_matmul(ar + ai, br + bi)
        re = t1 - t2
        im = t3 - t1 - t2
    else:
        raise ValueError(f"unknown complex algorithm {algorithm!r}")
    return torch.complex(re, im)


def gemm_flops(m: int, n: int, k: int, dtype: str) -> float:
    """Useful-FLOP count per dtype name: complex is charged 4x the real
    count, the mathematical form, so gauss3's 3 products show as an
    efficiency above 1, as the paper counts elementary operations."""
    base = 2.0 * m * n * k
    return 4.0 * base if getattr(torch, dtype).is_complex else base
