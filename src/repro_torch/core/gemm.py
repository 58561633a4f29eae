"""The GEMM chokepoint, with its backward.

Every dense contraction of the model (QKV/O projections, the SwiGLU MLP,
the tied-embedding logits) goes through `matmul()` / `dense()` /
`dense_q()` / `gated_mlp()` here, down to the dispatchers of
`kernels.ops`. On top of them this layer folds leading dims into M and
decides which epilogue rides the kernel's flush, by the rule of the JAX
package's `_dense_ep_2d` and `_dense_q_2d`: bias and activation ride it
together, a lone (m, n) residual rides it alone, and anything else is
added after.

`matmul`, `dense` and `gated_mlp` go through `torch.autograd.Function`s,
the counterparts of the JAX package's custom VJPs (`core/gemm.py`
`_matmul_bwd`, `_dense_ep_bwd`, `_gated_bwd`): every cotangent GEMM goes
through the same chokepoint, so on the card it runs on the tiled kernel
too. A call that autograd need not record (grad mode off, or no operand
that requires a gradient: serving) runs the same forward without the
Function, whose bookkeeping costs host time on every launch of a decode
step. The cotangents take the dtypes the JAX package gives them: the
incoming cotangent is cast to A's dtype, dA gets A's dtype and dB gets
B's, so a weight gradient is rounded to the activation dtype before the
cast back to the f32 parameter.

`matmul` routes by dtype, as the JAX package's `_matmul_2d` does:
complex64 through `precision.complex_matmul` ("gauss3", three real
GEMMs on the tiled kernel), float64 to the plain `ref.matmul_ref` (the
JAX package sends f64 to XLA: there is no f64 tile kernel), and the rest
to the tiled kernel. Its backward's GEMMs take the same route.

`dense_q` is forward only on the card: its int8 weight is a frozen
buffer, and the gradients of x, scale, b and residual (the JAX
package's `_dense_q_vjp`) are not ported yet, so a call there that
autograd would record raises rather than record nothing. On the CPU the
plain version is ordinary PyTorch, which autograd differentiates as it
is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import precision as _prec
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import ref as _ref

_ACTIVATIONS = {"gelu": lambda y: F.gelu(y, approximate="tanh"),
                "silu": F.silu}
_ACT_EPILOGUE = {"gelu": "bias_gelu", "silu": "bias_silu", None: "bias"}


def _fold(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


def _recorded(*operands) -> bool:
    """Whether autograd records a call on these operands."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in operands)


def _matmul_2d(a, b, out_dtype=None):
    """A @ B on 2D operands, routed by dtype as `repro/core/gemm.py`
    `_matmul_2d`: complex by gauss3 over the tiled kernel, float64 to the
    plain product, the rest to the tiled kernel."""
    if a.is_complex():
        return _prec.complex_matmul(a, b, _ops.matmul, algorithm="gauss3")
    if a.dtype == torch.float64:
        return _ref.matmul_ref(a, b, out_dtype)
    return _ops.matmul(a, b, out_dtype=out_dtype)


def _matmul_grads(a, b, g, needs=(True, True)):
    """(dA, dB) of A @ B for the cotangent g, as `_matmul_bwd`: g cast to
    A's dtype, dA = g Bᵀ in A's dtype, dB = Aᵀ g in B's (the conjugate
    transposes for complex, PyTorch's convention). Both real GEMMs read
    their transposed operand in place."""
    g = g.to(a.dtype).contiguous()
    at, bt = (a.t().conj(), b.t().conj()) if a.is_complex() else (a.t(), b.t())
    da = _matmul_2d(g, bt, out_dtype=a.dtype) if needs[0] else None
    db = _matmul_2d(at, g, out_dtype=b.dtype) if needs[1] else None
    return da, db


class _Matmul(torch.autograd.Function):
    """A @ B on 2D operands."""

    @staticmethod
    def forward(ctx, a, b, out_dtype):
        ctx.save_for_backward(a, b)
        return _matmul_2d(a, b, out_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return (*_matmul_grads(a, b, g, ctx.needs_input_grad[:2]), None)


def matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """A @ B for a: (..., M, K), b: (K, N)."""
    a2 = _fold(a)
    out = _Matmul.apply(a2, b, out_dtype) if _recorded(a2, b) \
        else _matmul_2d(a2, b, out_dtype)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def _dense_2d(gemm, x, n, b, r, activation):
    """act(gemm(x) + b) + r on 2D operands, where gemm(x, **flush) runs
    the kernel with an epilogue riding its flush and n is its width."""
    if b is not None or activation is not None:
        bias = b if b is not None else torch.zeros(
            n, dtype=x.dtype, device=x.device)
        y = gemm(x, epilogue=_ACT_EPILOGUE[activation], bias=bias)
        return y if r is None else y + r.to(y.dtype)
    if r is not None:
        if tuple(r.shape) == (x.shape[0], n):
            return gemm(x, epilogue="residual", residual=r)
        # a broadcastable, not (m, n), residual is added after the GEMM
        y = gemm(x)
        return y + r.to(y.dtype)
    return gemm(x)


def _check_activation(activation) -> None:
    if activation not in (None, *_ACTIVATIONS):
        raise ValueError(f"unknown activation {activation!r}; expected "
                         f"one of {(None, *_ACTIVATIONS)}")


def _dense_fwd(x, w, b, r, activation, out_dtype):
    return _dense_2d(
        lambda a, **kw: _ops.matmul(a, w, out_dtype=out_dtype, **kw),
        x, w.shape[-1], b, r, activation)


class _Dense(torch.autograd.Function):
    """act(x @ w + b) + r on 2D operands, the epilogue on the kernel's
    flush. The backward differentiates the unfused composition, as
    `_dense_ep_bwd` does: with an activation it recomputes z = x @ w + b
    through the chokepoint and takes the activation's derivative there;
    without one (none, bias, residual: a linear epilogue) there is
    nothing to recompute, and the cotangent goes straight to the two
    GEMMs, the bias (summed over rows) and the residual."""

    @staticmethod
    def forward(ctx, x, w, b, r, activation, out_dtype):
        ctx.save_for_backward(x, w, b, r)
        ctx.activation, ctx.out_dtype = activation, out_dtype
        return _dense_fwd(x, w, b, r, activation, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, b, r = ctx.saved_tensors
        g = g.to(ctx.out_dtype or x.dtype)
        dr = None if r is None else g.sum_to_size(r.shape).to(r.dtype)
        if ctx.activation is not None:
            z = _ops.matmul(x, w, out_dtype=g.dtype)
            if b is not None:
                z = z + b.reshape(-1).to(z.dtype)
            with torch.enable_grad():
                z = z.detach().requires_grad_()
                g, = torch.autograd.grad(_ACTIVATIONS[ctx.activation](z), z, g)
        db = None if b is None else g.sum_to_size(b.shape).to(b.dtype)
        dx, dw = _matmul_grads(x, w, g, ctx.needs_input_grad[:2])
        return dx, dw, db, dr, None, None


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
          *, activation: str | None = None,
          residual: torch.Tensor | None = None,
          out_dtype=None) -> torch.Tensor:
    """y = act(x @ w + b) + residual for x: (..., K), w: (K, N)."""
    _check_activation(activation)
    x2, r = _fold(x), None if residual is None else _fold(residual)
    out = _Dense.apply(x2, w, b, r, activation, out_dtype) \
        if _recorded(x2, w, b, r) \
        else _dense_fwd(x2, w, b, r, activation, out_dtype)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def dense_q(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
            b: torch.Tensor | None = None, *, activation: str | None = None,
            residual: torch.Tensor | None = None,
            out_dtype=None) -> torch.Tensor:
    """y = act((x @ wq) * scale + b) + residual for x: (..., K), wq an
    int8 (K, N) weight and scale its (1, N) per-channel f32 scale
    (`core.precision.quantize_int8`). The kernel streams the int8 weight
    and dequantizes on its f32 accumulator. Forward only on the card: a
    call there that autograd would record raises."""
    _check_activation(activation)
    if x.device.type == "cuda" and _recorded(x, scale, b, residual):
        raise NotImplementedError(
            "dense_q on the card is forward only: its backward (the "
            "gradients of x, scale, b and residual, as the JAX package's "
            "_dense_q_vjp) comes with int8 weights beyond the serving "
            "forward")
    r = None if residual is None else _fold(residual)
    out = _dense_2d(
        lambda a, **kw: _ops.matmul_q(a, wq, scale, out_dtype=out_dtype,
                                      **kw),
        _fold(x), wq.shape[-1], b, r, activation)
    return out.reshape(*x.shape[:-1], wq.shape[-1])


class _GatedMLP(torch.autograd.Function):
    """silu(x @ wg) * (x @ wu) on 2D operands, as one dual-GEMM kernel.
    The backward recomputes gate and up through the chokepoint and
    differentiates silu(gate) * up there, as `_gated_bwd` does: six GEMMs
    (two recomputes, dx and the weight gradient of each branch)."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up):
        ctx.save_for_backward(x, w_gate, w_up)
        return _ops.gated_matmul(x, w_gate, w_up)

    @staticmethod
    def backward(ctx, g):
        x, w_gate, w_up = ctx.saved_tensors
        with torch.enable_grad():
            gate = _ops.matmul(x, w_gate).requires_grad_()
            up = _ops.matmul(x, w_up).requires_grad_()
            d_gate, d_up = torch.autograd.grad(F.silu(gate) * up, (gate, up),
                                               g.to(x.dtype))
        needs = ctx.needs_input_grad
        dx_g, dw_gate = _matmul_grads(x, w_gate, d_gate, (needs[0], needs[1]))
        dx_u, dw_up = _matmul_grads(x, w_up, d_up, (needs[0], needs[2]))
        return None if dx_g is None else dx_g + dx_u, dw_gate, dw_up


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor) -> torch.Tensor:
    """silu(x @ w_gate) * (x @ w_up), the SwiGLU hidden phase, as one
    dual-GEMM kernel."""
    x2 = _fold(x)
    out = _GatedMLP.apply(x2, w_gate, w_up) if _recorded(x2, w_gate, w_up) \
        else _ops.gated_matmul(x2, w_gate, w_up)
    return out.reshape(*x.shape[:-1], w_gate.shape[-1])
