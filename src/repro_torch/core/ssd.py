"""The SSD chokepoint: every chunked Mamba-2 scan of the model
(`models/ssm.py::mamba_apply`: prefill and training) goes through `ssd()`
here, down to the `kernels.ops.ssd` dispatcher: the intra-chunk CUDA
kernel for tensors on the card, the plain `ref.ssd_chunked_ref` on the
CPU.

A call that autograd records goes through `_SSD`, the counterpart of the
JAX package's custom VJP `_ssd_fused`: its forward is that dispatcher
(the kernel on the card), and its backward is the derivative of the
unfused composition, `ref.ssd_chunked_ref` recomputed from the saved
inputs and differentiated by autograd in f32, as the reference
differentiates `ssd_chunked` (the JAX package has no SSD backward
kernel). CPU and card take the same Function. A call that autograd need
not record (serving) runs the dispatcher without it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as _ops
from repro_torch.kernels import ref as _ref


class _SSD(torch.autograd.Function):
    """(y, final_state) of the scan; the gradients of x, a, b, c and the
    initial state. A missing cotangent (y or the final state unused) is
    materialized as zeros, as the reference's VJP takes it."""

    @staticmethod
    def forward(ctx, x, a, b, c, s0, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, a, b, c, s0)
        return _ops.ssd(x, a, b, c, chunk, init_state=s0)

    @staticmethod
    def backward(ctx, dy, ds):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
            y, s = _ref.ssd_chunked_ref(*ins[:4], ctx.chunk, ins[4])
        wrt = [t for t, n in zip(ins, needs) if n]
        grads = iter(torch.autograd.grad((y, s), wrt, (dy, ds)))
        return (*(next(grads) if n else None for n in needs), None)


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        chunk: int, init_state: torch.Tensor | None = None):
    """Chunked SSD scan of x (B, L, H, P) dt-scaled inputs, a (B, L, H)
    log-decays and b/c (B, L, G, N). Returns (y (B, L, H, P) in x's
    dtype, final_state (B, H, P, N) float32). A missing init_state is a
    zero state, as in the JAX package."""
    bsz, _, h, p = x.shape
    n = b.shape[-1]
    if init_state is None:
        init_state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                                 device=x.device)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, a, b, c, init_state)):
        return _SSD.apply(x, a, b, c, init_state, chunk)
    return _ops.ssd(x, a, b, c, chunk, init_state=init_state)
