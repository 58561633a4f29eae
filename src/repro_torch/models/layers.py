"""Shared building blocks: dense layers, norms, embeddings, rotary and
sinusoid positions.

Plain functions on tensors over a params dict of the same keys and
shapes as the JAX package's (`repro/models/layers.py`).

Under a mesh whose "model" axis is wider than 1
(`distributed.context.model_group`), the embedding table and the head
are this rank's block of the vocab (`distributed.sharding.model_layout`):
the lookup is vocab-parallel (each rank gathers the ids it holds, the
rows summed over the group), and the logits are column-parallel, joined
along the vocab by an all-gather. `row_parallel_apply` is a row-parallel
dense layer (O, down). Without such a mesh nothing here changes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import distributed as D
from repro_torch.core import gemm
from repro_torch.core import precision
from repro_torch.distributed import context as ctx


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


def row_parallel_apply(p, x, group, *, residual=None):
    """A dense layer whose weight is this rank's block of K rows (its
    input this rank's block of features): the partial product summed
    over `group` (`core.distributed.row_parallel`), then the bias and the
    residual, each added once, after the sum."""
    y = D.row_parallel(x, p["w"].to(x.dtype), axis=group, scatter=False)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y if residual is None else y + residual.to(y.dtype)


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


def layernorm_init(d: int, *, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p, x, *, eps: float = 1e-5):
    """(x - mean) / sqrt(var + eps) * scale + bias over the last dim, in
    f32, the variance the population's; both means through `_row_mean`,
    so a row's bits do not depend on how many rows x has."""
    xf = x.float()
    xc = xf - _row_mean(xf)
    y = xc * torch.rsqrt(_row_mean(xc * xc) + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def sinusoid_at(d: int, pos: torch.Tensor) -> torch.Tensor:
    """Whisper-style fixed sinusoids, f32, at the positions `pos` (any
    shape, read as f32): (*pos.shape, d), sin on the even lanes and cos
    on the odd ones, of pos * 10000^(-2i / d) (the JAX package's
    interleaved layout, not Whisper's concatenated one). A position
    tensor on the card gives the rows there, with no host sync."""
    div = torch.exp(-math.log(10_000.0)
                    * torch.arange(0, d, 2, dtype=torch.float32,
                                   device=pos.device) / d)
    ang = pos.float()[..., None] * div
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1) \
        .reshape(*pos.shape, d)


def sinusoid_positions(t: int, d: int, offset: int = 0,
                       device=None) -> torch.Tensor:
    """The (t, d) f32 sinusoids of positions offset .. offset + t - 1."""
    return sinusoid_at(d, torch.arange(offset, offset + t, device=device))


def embed_init(generator, vocab: int, d: int, *, dtype, device):
    w = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                    device=generator.device) * (d ** -0.5)
    return {"w": w.to(device=device, dtype=dtype)}


def embed_apply(p, ids, *, dtype):
    """The rows of the table for `ids`, in `dtype`. The gradient is plain
    PyTorch, a scatter-add of each row's cotangent into the table (an
    index_put with accumulate), as XLA scatters it. Vocab-parallel under
    a "model" group (the module's docstring): the ids outside this rank's
    rows give zeros, and the rows are summed over the group."""
    group = ctx.model_group()
    if group is None:
        return p["w"][ids].to(dtype)
    rows = p["w"].shape[0]
    local = ids - D._rank(group) * rows
    inside = (local >= 0) & (local < rows)
    e = p["w"][local.clamp(0, rows - 1)].to(dtype)
    return D.reduce_from(torch.where(inside[..., None], e, 0), group)


def embed_attend(p, x, *, gather: bool = True):
    """Tied-embedding logits x @ W^T in f32. W^T is the transpose view of
    the [vocab, d] table: the GEMM kernel reads it in place. Under a
    "model" group each rank's block of the vocab, joined by an
    all-gather unless gather=False."""
    group = ctx.model_group()
    y = gemm.matmul(D.copy_to(x, group), p["w"].to(x.dtype).t(),
                    out_dtype=torch.float32)
    return D.gather_from(y, group) if gather else y


# ----------------------------------------------------------------------
# Rotary embeddings (half-split, as the JAX package applies them), and
# Qwen2-VL's M-RoPE
# ----------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections=None) -> torch.Tensor:
    """x: [B, T, H, D]; positions: [B, T], or [B, T, 3] (M-RoPE, with
    `mrope_sections`). The two halves of the head dim rotate as (re, im)
    pairs, not interleaved lanes. M-RoPE (Qwen2-VL) cuts the d/2
    frequency slots into (temporal, height, width) sections, each turned
    by its own position stream; a text token carries t = h = w, whose
    angles are plain RoPE's, bit for bit."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    if positions.dim() == 2:
        ang = positions[..., None].float() * freqs          # [B, T, d/2]
    else:
        if mrope_sections is None or sum(mrope_sections) != d // 2:
            raise ValueError(f"(B, T, 3) positions need mrope_sections "
                             f"summing to {d // 2}, got {mrope_sections}")
        parts, start = [], 0
        for i, sec in enumerate(mrope_sections):
            parts.append(positions[..., i, None].float()
                         * freqs[start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)                      # [B, T, d/2]
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
