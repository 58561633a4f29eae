"""The SSD chokepoint: every chunked Mamba-2 scan of the model
(`models/ssm.py::mamba_apply`, prefill) goes through `ssd()` here, down
to the `kernels.ops.ssd` dispatcher: the intra-chunk CUDA kernel for
tensors on the card, the plain `ref.ssd_chunked_ref` on the CPU.

Forward only in this slice. The JAX package trains through a custom VJP
that differentiates the unfused `ssd_chunked`; its counterpart here, a
`torch.autograd.Function` whose backward differentiates
`ref.ssd_chunked_ref`, comes with mamba2 training. Until then a call on
the card that autograd would record raises, rather than record nothing.
On the CPU the plain version is ordinary PyTorch, which autograd
differentiates as it is.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as _ops


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
    if x.device.type == "cuda" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, a, b, c, init_state)):
        raise NotImplementedError(
            "the SSD kernel is forward only: its backward (an autograd "
            "Function over ref.ssd_chunked_ref) comes with the mamba2 "
            "training slice")
    return _ops.ssd(x, a, b, c, chunk, init_state=init_state)
