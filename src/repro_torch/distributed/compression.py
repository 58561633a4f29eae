"""Gradient compression: int8 quantisation with error feedback, the JAX
package's `distributed/compression.py` on trees of tensors.

Each gradient leaf is quantised to int8 with a per-tensor scale (max |g|
/ 127); the quantisation error is kept in a buffer and added to the next
step's gradient (error feedback, EF-SGD), which restores convergence to
the uncompressed path in expectation. f32 arithmetic throughout; torch
and jnp both round half to even, so the int8 values, the scales and the
error buffers are the reference's bit for bit.

Under tensor parallelism a leaf sharded over "model" takes the scale of
the whole leaf: its max |g| is all-reduced (MAX) over the group first,
so every shard's int8 values are the reference's for the whole gradient.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core.tree import leaves, tree_map


class EFState(NamedTuple):
    error: Any         # the grads' structure, f32


def init_ef(params) -> EFState:
    return EFState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _absmax(x: torch.Tensor, group=None) -> torch.Tensor:
    m = torch.max(torch.abs(x))
    if group is not None:
        import torch.distributed as dist
        m = m.clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    return m


def quantize(x: torch.Tensor, *, group=None) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(int8 q, f32 scale) of x; group: the ranks whose blocks of one leaf
    x is, whose max |x| the scale takes."""
    scale = _absmax(x, group) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads(grads, ef: EFState, *, sharded=None, group=None):
    """(the grads as the receiving side would dequantise them, the new EF
    state). sharded: a tree of bools matching grads, True for a leaf that
    is this rank's block of a leaf sharded over `group` (its scale is the
    whole leaf's); None: every leaf whole."""
    if sharded is None:
        sharded = tree_map(lambda _: False, grads)

    def one(g, e, shard):
        gf = g.to(torch.float32) + e
        q, s = quantize(gf, group=group if shard else None)
        deq = dequantize(q, s)
        return deq.to(g.dtype), gf - deq

    out = tree_map(one, grads, ef.error, sharded)
    return (tree_map(lambda _, o: o[0], grads, out),
            EFState(error=tree_map(lambda _, o: o[1], grads, out)))


def compression_ratio(params, bits: int = 8) -> float:
    xs = leaves(params)
    total = sum(x.numel() * x.element_size() for x in xs)
    comp = sum(x.numel() * bits // 8 + 4 for x in xs)
    return total / comp
