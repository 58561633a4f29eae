"""Plain PyTorch versions of the port's CUDA kernels, in the order of
`repro/kernels/ref.py`.

Each is the function its kernel computes, written with ordinary tensor
operations: the kernel wrappers run them for tensors on the CPU (the
tests hold them against the JAX Pallas kernels in interpret mode), and
`chip_smoke.py` holds each CUDA kernel against them on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPILOGUES = ("none", "bias", "bias_gelu", "bias_silu", "residual")


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """C = A @ B with f32 accumulation (f64 for f64 inputs)."""
    out_dtype = out_dtype or a.dtype
    acc = _acc_dtype(a.dtype)
    return torch.matmul(a.to(acc), b.to(acc)).to(out_dtype)


def epilogue_ref(y: torch.Tensor, epilogue: str, bias=None,
                 residual=None) -> torch.Tensor:
    """The epilogue lattice on `y`, in y's dtype. gelu is the tanh
    approximation, as `jax.nn.gelu` is by default."""
    if epilogue == "none":
        return y
    if epilogue == "residual":
        return y + residual.to(y.dtype)
    y = y + bias.reshape(-1).to(y.dtype)
    if epilogue == "bias_gelu":
        y = F.gelu(y, approximate="tanh")
    elif epilogue == "bias_silu":
        y = F.silu(y)
    return y


def fused_matmul_ref(a, b, out_dtype=None, epilogue="none", bias=None,
                     residual=None) -> torch.Tensor:
    """What the tiled kernel computes: the epilogue applied to the f32
    accumulator, the operand cast to the accumulator's dtype, and one
    rounding to `out_dtype` at the end."""
    out_dtype = out_dtype or a.dtype
    acc = matmul_ref(a, b, out_dtype=_acc_dtype(a.dtype))
    return epilogue_ref(acc, epilogue, bias, residual).to(out_dtype)


def gated_matmul_ref(a, w_gate, w_up) -> torch.Tensor:
    """silu(A @ Wg) * (A @ Wu) with f32 accumulation, the gate product
    taken in the accumulator's dtype and rounded once to A's."""
    acc = _acc_dtype(a.dtype)
    g = torch.matmul(a.to(acc), w_gate.to(acc))
    u = torch.matmul(a.to(acc), w_up.to(acc))
    return (F.silu(g) * u).to(a.dtype)


def attention_fwd_ref(q, k, v, *, window=None, q_offset=0):
    """Causal softmax attention under the decode contract.

    q [B, Tq, H, D] attends k/v [B, Tk, Hkv, D] (GQA: query head h reads
    kv head h // (H // Hkv)); query row i of batch b sits at position
    q_offset[b] + i and sees keys (pos - window, pos]. A row that sees no
    key (pos < 0, an idle serving slot) gives a zero output, as the
    JAX reference's exp(S - lse) form does. Returns [B, Tq, H, D] in
    q's dtype."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float() * d ** -0.5
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    off = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1, 1)
    q_pos = torch.arange(tq, device=q.device)[None, :, None] + off
    k_pos = torch.arange(tk, device=q.device)[None, None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    mask = mask[:, None]                                  # (Bm, 1, Tq, Tk)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - lse), torch.zeros_like(logits))
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype)
