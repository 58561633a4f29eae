"""The GEMM chokepoint, forward only.

Every dense contraction of the model (QKV/O projections, the SwiGLU MLP,
the tied-embedding logits) goes through `matmul()` / `dense()` /
`gated_mlp()` here, down to the dispatchers of `kernels.ops`. On top of
them this layer folds leading dims into M and decides which epilogue
rides the kernel's flush, by the rule of the JAX package's
`_dense_ep_2d`: bias and activation ride it together, a lone (m, n)
residual rides it alone, and anything else is added after.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as _ops

_ACTIVATIONS = {"gelu": lambda y: F.gelu(y, approximate="tanh"),
                "silu": F.silu}
_ACT_EPILOGUE = {"gelu": "bias_gelu", "silu": "bias_silu", None: "bias"}


def _fold(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """A @ B for a: (..., M, K), b: (K, N)."""
    out = _ops.matmul(_fold(a), b, out_dtype=out_dtype)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def _dense_2d(x, w, b, r, activation, out_dtype):
    if b is not None or activation is not None:
        bias = b if b is not None else torch.zeros(
            w.shape[-1], dtype=x.dtype, device=x.device)
        y = _ops.matmul(x, w, out_dtype=out_dtype,
                        epilogue=_ACT_EPILOGUE[activation], bias=bias)
        return y if r is None else y + r.to(y.dtype)
    if r is not None:
        if tuple(r.shape) == (x.shape[0], w.shape[-1]):
            return _ops.matmul(x, w, out_dtype=out_dtype, epilogue="residual",
                               residual=r)
        # a broadcastable, not (m, n), residual is added after the GEMM
        y = _ops.matmul(x, w, out_dtype=out_dtype)
        return y + r.to(y.dtype)
    return _ops.matmul(x, w, out_dtype=out_dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
          *, activation: str | None = None,
          residual: torch.Tensor | None = None,
          out_dtype=None) -> torch.Tensor:
    """y = act(x @ w + b) + residual for x: (..., K), w: (K, N)."""
    if activation not in (None, *_ACTIVATIONS):
        raise ValueError(f"unknown activation {activation!r}; expected "
                         f"one of {(None, *_ACTIVATIONS)}")
    r = None if residual is None else _fold(residual)
    out = _dense_2d(_fold(x), w, b, r, activation, out_dtype)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor) -> torch.Tensor:
    """silu(x @ w_gate) * (x @ w_up), the SwiGLU hidden phase, as one
    dual-GEMM kernel."""
    out = _ops.gated_matmul(_fold(x), w_gate, w_up)
    return out.reshape(*x.shape[:-1], w_gate.shape[-1])
