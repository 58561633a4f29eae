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

`dense_q` goes through `_DenseQ`, the counterpart of the JAX package's
`_dense_q_vjp`, on the CPU and on the card alike: the forward is the
int8-weight kernel; the backward differentiates the dequantized
composition, w = (wq * scale) in x's dtype, by the dense chokepoint's
own backward (`_dense_grads`, its GEMMs on the tiled kernel), and d
scale is the sum over K of d w * wq. The int8 weight is a frozen leaf
and gets no gradient.

`matmul` and `gated_mlp` also take a bank of weights, b or w (E, K, N)
against a (E, M, K): the MoE expert GEMMs, which the JAX package vmaps
over its 2D chokepoint and its custom VJPs. They run the batched forms of
the kernels, one launch for all E experts (`kernels.ops.matmul_batched`,
`gated_matmul_batched`), and so do their backwards (`_MatmulBank`,
`_GatedMLPBank`): each expert's dA = g B^T and dB = A^T g, the batched
GEMM reading the transposed operand of every expert in place, with the
2-D Functions' dtypes (a bf16 bank's gradient is bf16, cast back to the
f32 param by the caller's `.to()`, as in the JAX package).
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


def _check_bank(what: str, a, ws, out_dtype):
    if a.dim() != 3:
        raise ValueError(f"{what} against a bank {tuple(ws[0].shape)} takes "
                         f"a (E, M, K), got {tuple(a.shape)}")
    if out_dtype not in (None, a.dtype):
        raise ValueError(f"{what} against a bank gives a's dtype {a.dtype}, "
                         f"not {out_dtype}")


def _bank_grads(a, b, g, needs=(True, True)):
    """(dA, dB) of the bank product a[e] @ b[e] for the cotangent g, as
    `_matmul_grads` per expert: g cast to A's dtype, dA[e] = g[e] B[e]^T
    in A's dtype, dB[e] = A[e]^T g[e] in B's (one dtype: a bank GEMM
    takes A's). Both batched GEMMs read their transposed operand in
    place (`transpose(1, 2)` views)."""
    g = g.to(a.dtype).contiguous()
    da = _ops.matmul_batched(g, b.transpose(1, 2)) if needs[0] else None
    db = _ops.matmul_batched(a.transpose(1, 2), g) if needs[1] else None
    return da, db


class _MatmulBank(torch.autograd.Function):
    """a[e] @ b[e] over a bank, one batched launch; the backward is two."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _ops.matmul_batched(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return _bank_grads(a, b, g, ctx.needs_input_grad)


def matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """A @ B for a: (..., M, K), b: (K, N); or for a bank b (E, K, N)
    against a (E, M, K), each expert's product in a's dtype, through the
    batched kernel (its backward too)."""
    if b.dim() == 3:
        _check_bank("matmul", a, (b,), out_dtype)
        if _recorded(a, b):
            return _MatmulBank.apply(a, b)
        return _ops.matmul_batched(a, b)
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


def _dense_grads(x, w, b, r, activation, out_dtype, g, needs=(True, True)):
    """(dx, dw, db, dr) of act(x @ w + b) + r for the cotangent g, as
    `_dense_ep_bwd`: with an activation, z = x @ w + b is recomputed
    through the chokepoint and the activation's derivative taken there;
    without one (none, bias, residual: a linear epilogue) there is
    nothing to recompute, and the cotangent goes straight to the two
    GEMMs (dx and dw as `needs` asks), the bias (summed over rows) and
    the residual."""
    g = g.to(out_dtype or x.dtype)
    dr = None if r is None else g.sum_to_size(r.shape).to(r.dtype)
    if activation is not None:
        z = _ops.matmul(x, w, out_dtype=g.dtype)
        if b is not None:
            z = z + b.reshape(-1).to(z.dtype)
        with torch.enable_grad():
            z = z.detach().requires_grad_()
            g, = torch.autograd.grad(_ACTIVATIONS[activation](z), z, g)
    db = None if b is None else g.sum_to_size(b.shape).to(b.dtype)
    dx, dw = _matmul_grads(x, w, g, needs)
    return dx, dw, db, dr


class _Dense(torch.autograd.Function):
    """act(x @ w + b) + r on 2D operands, the epilogue on the kernel's
    flush; the backward differentiates the unfused composition
    (`_dense_grads`)."""

    @staticmethod
    def forward(ctx, x, w, b, r, activation, out_dtype):
        ctx.save_for_backward(x, w, b, r)
        ctx.activation, ctx.out_dtype = activation, out_dtype
        return _dense_fwd(x, w, b, r, activation, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w, b, r = ctx.saved_tensors
        return (*_dense_grads(x, w, b, r, ctx.activation, ctx.out_dtype, g,
                              ctx.needs_input_grad[:2]), None, None)


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


def _dense_q_fwd(x, wq, scale, b, r, activation, out_dtype):
    return _dense_2d(
        lambda a, **kw: _ops.matmul_q(a, wq, scale, out_dtype=out_dtype,
                                      **kw),
        x, wq.shape[-1], b, r, activation)


class _DenseQ(torch.autograd.Function):
    """act((x @ wq) * scale + b) + r on 2D operands, the int8-weight
    kernel's forward. The backward, as `_dense_q_bwd`: the dequantized
    weight w = (wq * scale) in x's dtype, the dense composition's
    gradients on it (`_dense_grads`: dx, dw, db, dr, every GEMM through
    the chokepoint), d scale = the sum over K of dw * wq in f32 (the
    dequantization's chain rule), and none for the int8 wq."""

    @staticmethod
    def forward(ctx, x, wq, scale, b, r, activation, out_dtype):
        ctx.save_for_backward(x, wq, scale, b, r)
        ctx.activation, ctx.out_dtype = activation, out_dtype
        return _dense_q_fwd(x, wq, scale, b, r, activation, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, wq, scale, b, r = ctx.saved_tensors
        needs = ctx.needs_input_grad
        w = (wq.float() * scale.reshape(1, -1)).to(x.dtype)
        dx, dw, db, dr = _dense_grads(x, w, b, r, ctx.activation,
                                      ctx.out_dtype, g, (needs[0], needs[2]))
        dscale = None if dw is None else (dw.float() * wq.float()).sum(
            0, keepdim=True).reshape(scale.shape).to(scale.dtype)
        return dx, None, dscale, db, dr, None, None


def dense_q(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
            b: torch.Tensor | None = None, *, activation: str | None = None,
            residual: torch.Tensor | None = None,
            out_dtype=None) -> torch.Tensor:
    """y = act((x @ wq) * scale + b) + residual for x: (..., K), wq an
    int8 (K, N) weight and scale its (1, N) per-channel f32 scale
    (`core.precision.quantize_int8`). The kernel streams the int8 weight
    and dequantizes on its f32 accumulator. A call that autograd records
    goes through `_DenseQ`: x, scale, b and residual get gradients, the
    frozen int8 weight none."""
    _check_activation(activation)
    x2, r = _fold(x), None if residual is None else _fold(residual)
    out = _DenseQ.apply(x2, wq, scale, b, r, activation, out_dtype) \
        if _recorded(x2, scale, b, r) \
        else _dense_q_fwd(x2, wq, scale, b, r, activation, out_dtype)
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


class _GatedMLPBank(torch.autograd.Function):
    """silu(x[e] @ wg[e]) * (x[e] @ wu[e]) over banks, one batched dual
    GEMM; the backward is `_GatedMLP.backward` for every expert at once:
    gate and up recomputed by the batched GEMM, silu(gate) * up
    differentiated there, then four batched cotangent GEMMs."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up):
        ctx.save_for_backward(x, w_gate, w_up)
        return _ops.gated_matmul_batched(x, w_gate, w_up)

    @staticmethod
    def backward(ctx, g):
        x, w_gate, w_up = ctx.saved_tensors
        with torch.enable_grad():
            gate = _ops.matmul_batched(x, w_gate).requires_grad_()
            up = _ops.matmul_batched(x, w_up).requires_grad_()
            d_gate, d_up = torch.autograd.grad(F.silu(gate) * up, (gate, up),
                                               g.to(x.dtype))
        needs = ctx.needs_input_grad
        dx_g, dw_gate = _bank_grads(x, w_gate, d_gate, (needs[0], needs[1]))
        dx_u, dw_up = _bank_grads(x, w_up, d_up, (needs[0], needs[2]))
        return None if dx_g is None else dx_g + dx_u, dw_gate, dw_up


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor) -> torch.Tensor:
    """silu(x @ w_gate) * (x @ w_up), the SwiGLU hidden phase, as one
    dual-GEMM kernel; for banks w_gate, w_up (E, K, F) against x (E, M, K),
    each expert's through the batched dual GEMM (its backward through the
    batched GEMM)."""
    if w_gate.dim() == 3:
        _check_bank("gated_mlp", x, (w_gate, w_up), None)
        if _recorded(x, w_gate, w_up):
            return _GatedMLPBank.apply(x, w_gate, w_up)
        return _ops.gated_matmul_batched(x, w_gate, w_up)
    x2 = _fold(x)
    out = _GatedMLP.apply(x2, w_gate, w_up) if _recorded(x2, w_gate, w_up) \
        else _ops.gated_matmul(x2, w_gate, w_up)
    return out.reshape(*x.shape[:-1], w_gate.shape[-1])
