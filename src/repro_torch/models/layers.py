"""Shared building blocks: dense layers, norms, embeddings, rotary.

Plain functions on tensors over a params dict of the same keys and
shapes as the JAX package's (`repro/models/layers.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import gemm
from repro_torch.core import precision


def dense_init(generator, d_in: int, d_out: int, *, dtype, device,
               scale: float | None = None, bias: bool = False):
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=generator.device) * scale
    p = {"w": w.to(device=device, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense_quantize(p):
    """{"w": float, "b"?} -> {"w_q": int8, "w_scale": f32 per-channel,
    "b"?} (`precision.quantize_int8` over the contraction axis). A stacked
    (L, K, N) weight gets (L, 1, N) scales, which indexing a layer slices
    alongside the int8 leaf."""
    q, s = precision.quantize_int8(p["w"])
    out = {"w_q": q, "w_scale": s}
    if "b" in p:
        out["b"] = p["b"]
    return out


def dense_apply(p, x, *, out_dtype=None, activation=None, residual=None):
    """activation/residual ride the GEMM kernel's flush (core.gemm).
    Quantized params ({"w_q", "w_scale"}) take the int8-weight GEMM. A
    float weight is cast to x's dtype as the JAX package casts it, and
    its gradient flows back through the cast to the f32 parameter; the
    serving engine casts its weights once, so this is then a no-op."""
    if "w_q" in p:
        return gemm.dense_q(x, p["w_q"], p["w_scale"], p.get("b"),
                            activation=activation, residual=residual,
                            out_dtype=out_dtype)
    return gemm.dense(x, p["w"].to(x.dtype), p.get("b"),
                      activation=activation, residual=residual,
                      out_dtype=out_dtype)


def gated_apply(p_gate, p_up, x):
    """SwiGLU hidden phase through the dual-GEMM kernel. Quantized
    weights take two int8-weight GEMMs and the gate product after them,
    as the JAX package does (it has no int8 dual-GEMM kernel)."""
    if "w_q" in p_gate:
        g = gemm.dense_q(x, p_gate["w_q"], p_gate["w_scale"])
        u = gemm.dense_q(x, p_up["w_q"], p_up["w_scale"])
        return (F.silu(g) * u).to(g.dtype)
    return gemm.gated_mlp(x, p_gate["w"].to(x.dtype), p_up["w"].to(x.dtype))


def rmsnorm_init(d: int, *, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last dim, in an order that does not depend on how
    many rows x has, so that a decode step at 4 slots normalises each row
    to the bits of the same row alone. PyTorch's CUDA reduction splits
    one reduction over a whole row across more threads the fewer rows
    there are, which sums in another order; two reductions, over fixed
    blocks of k values and then over the d / k block means (at least 16
    blocks a row), are laid out alike at any row count
    (`tests/test_torch_cuda.py` holds this on the card). k is a power of
    two, so the block means are the block sums scaled exactly."""
    d = x.shape[-1]
    k = 128
    while k > 1 and (d % k or d // k < 16):
        k //= 2
    return x.reshape(*x.shape[:-1], d // k, k).mean(-1).mean(-1, keepdim=True)


def rmsnorm_apply(p, x, *, eps: float = 1e-6):
    xf = x.float()
    var = _row_mean(xf * xf)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def embed_init(generator, vocab: int, d: int, *, dtype, device):
    w = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                    device=generator.device) * (d ** -0.5)
    return {"w": w.to(device=device, dtype=dtype)}


def embed_apply(p, ids, *, dtype):
    """The rows of the table for `ids`, in `dtype`. The gradient is plain
    PyTorch, a scatter-add of each row's cotangent into the table (an
    index_put with accumulate), as XLA scatters it."""
    return p["w"][ids].to(dtype)


def embed_attend(p, x):
    """Tied-embedding logits x @ W^T in f32. W^T is the transpose view of
    the [vocab, d] table: the GEMM kernel reads it in place."""
    return gemm.matmul(x, p["w"].to(x.dtype).t(), out_dtype=torch.float32)


# ----------------------------------------------------------------------
# Rotary embeddings (half-split, as the JAX package applies them)
# ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [B, T]. The two halves of the head dim
    rotate as (re, im) pairs, not interleaved lanes."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    ang = positions[..., None].float() * freqs              # [B, T, d/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def default_positions(b: int, t: int, offset=0, device=None) -> torch.Tensor:
    """offset: an int (uniform batch) or a (B,) per-slot position vector."""
    pos = torch.arange(t, dtype=torch.int32, device=device)[None]
    if isinstance(offset, torch.Tensor) and offset.dim() == 1:
        pos = pos + offset.to(device=device, dtype=torch.int32)[:, None]
    else:
        pos = pos + int(offset)
    return pos.expand(b, t)
