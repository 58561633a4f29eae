"""Mixture-of-experts FFN with GShard-style capacity routing: the family
moe, Mixtral (8 experts, top-2) and Arctic (128 experts, top-2, and a
parallel dense SwiGLU branch), as the JAX package's `models/moe.py`
computes it.

Tokens are cut into G groups of S (the largest divisor of the token
count up to `group_size`). In each group the f32 router picks every
token's top-k experts; an expert takes at most C = max(4, top_k * S *
capacity_factor / E) of a group's assignments, in token order, every
token's first choice before any second choice, and an assignment past C
is dropped. Dispatch gathers each expert's C slots a group into one
(E, G * C, D) bank of rows (an empty slot reads a zero row); the expert
SwiGLU runs as two batched kernels, the dual GEMM and the down GEMM,
one launch each for all E experts; combine gathers each token's k slot
rows back and sums them, weighted by the renormalised top-k
probabilities, in f32.

Where the reference multiplies one-hot (G, S, E, C) tensors
(`dispatch="einsum"`, GShard's form), the port gathers by index: the
one-hot product reads one row, or none, for each slot, so the gather
gives its values; its combine weights are rounded to the activation
dtype as the einsum's are, and a token's k terms are summed in f32 (two
terms for top-2, whose sum does not depend on their order).
`dispatch="gather"` keeps the weights in f32, as the reference's
index form does. One difference by design: the einsum multiplies every
slot row of a group by every token's weights, so a non-finite expert row
makes the whole group non-finite there; the gather reads only a token's
own slots.

Routing is written for a CUDA graph: no host sync (capacity positions by
a cumsum of one-hot masks, dropped assignments scattered into a spare
slot past C that no GEMM reads), and S, G and C are host integers of the
shapes. The top-k takes a stable descending sort, so that a tie goes to
the lower expert index, as `jax.lax.top_k` breaks it. The softmax sums
its row by a fixed pairwise tree, so a token's probabilities keep their
bits at any number of tokens (a decode step at 4 slots and the same row
alone). The router stays f32, whatever the params' dtype.

The auxiliary losses (load balance, router z-loss) and the dropped
fraction are computed only for a caller that passes an `aux` dict: a
serving step launches none of their reductions.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import gemm
from repro_torch.models import ffn as F
from repro_torch.models import layers as L

DISPATCH_MODES = ("einsum", "gather")


def moe_init(generator, cfg, *, device, banks=True):
    """The router {"w": (D, E)} in f32 whatever param_dtype, the raw expert
    banks w_gate, w_up (E, D, F) and w_down (E, F, D) (`bank_init`;
    banks=False leaves them out, for a stack that draws them stacked),
    and Arctic's dense SwiGLU branch of width dense_ff, scaled as the JAX
    package scales them."""
    mc = cfg.moe
    p = {"router": L.dense_init(generator, cfg.d_model, mc.n_experts,
                                dtype=torch.float32, device=device)}
    if banks:
        p.update(bank_init(generator, cfg, device=device))
    if mc.dense_ff:
        p["dense"] = F.mlp_init(generator,
                                dataclasses.replace(cfg, d_ff=mc.dense_ff),
                                device=device)
    return p


def bank_init(generator, cfg, *, device, n_layers=None):
    """The expert banks {"w_gate", "w_up": (E, D, F), "w_down": (E, F, D)}
    in param_dtype, with a leading (n_layers,) dim where given: each
    expert's matrix drawn in f32 and cast into its place in turn, so a
    full-width bank is never held in f32 nor stacked from copies (one
    layer of arctic-480b's is 27 GB in bf16)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    dtype = getattr(torch, cfg.param_dtype)
    lead = () if n_layers is None else (n_layers,)
    down_scale = f ** -0.5 / (2 * cfg.n_layers) ** 0.5
    out = {}
    for name, d_in, d_out, scale in (("w_gate", d, f, d ** -0.5),
                                     ("w_up", d, f, d ** -0.5),
                                     ("w_down", f, d, down_scale)):
        bank = torch.empty((*lead, e, d_in, d_out), dtype=dtype,
                           device=device)
        for m in bank.view(-1, d_in, d_out):
            m.copy_(torch.randn((d_in, d_out), generator=generator,
                                dtype=torch.float32,
                                device=generator.device) * scale)
        out[name] = bank
    return out


def _capacity(mc, s: int) -> int:
    c = int(mc.top_k * s * mc.capacity_factor / mc.n_experts)
    return max(4, c)


def group_size(mc, n_tokens: int) -> int:
    """The largest divisor of n_tokens that is at most mc.group_size."""
    s = min(mc.group_size, n_tokens)
    while n_tokens % s:
        s -= 1
    return s


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim by a fixed pairwise tree (a leftover odd
    element joins at the end of its level): the same order for every row,
    whatever the row count."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = n // 2
        y = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([y, x[..., 2 * h:]], dim=-1) if n % 2 else y
    return x


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """exp(x - max) / sum(exp(x - max)) over the last dim, as
    `jax.nn.softmax` writes it (no gradient through the max, which
    cancels), the sum by `_tree_sum`."""
    ex = torch.exp(logits - logits.amax(-1, keepdim=True).detach())
    return ex / _tree_sum(ex)


def _route(p, xg, mc):
    """The router on xg (G, S, D): (logits, probs, top_p, top_i, pos, keep,
    c) as the reference's `_route` returns them: f32 logits and probs
    (G, S, E), the renormalised top-k probabilities and expert ids (G, S,
    k), each assignment's capacity position and whether it is kept (pos <
    c), and the capacity c."""
    e, k = mc.n_experts, mc.top_k
    g, s, _ = xg.shape
    c = _capacity(mc, s)
    logits = L.dense_apply(p["router"], xg.float())            # (G, S, E)
    probs = _softmax(logits)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / _tree_sum(top_p)                            # renorm

    experts = torch.arange(e, device=xg.device)
    counts = torch.zeros((g, 1, e), dtype=torch.int64, device=xg.device)
    pos_k, keep_k = [], []
    for kk in range(k):
        idx = top_i[..., kk, None]
        mask = (idx == experts).long()                          # (G, S, E)
        pos = counts + torch.cumsum(mask, dim=1) - mask
        pos_k.append(pos.gather(-1, idx)[..., 0])
        keep_k.append(pos_k[-1] < c)
        counts = counts + mask.sum(1, keepdim=True)
    return (logits, probs, top_p, top_i, torch.stack(pos_k, -1),
            torch.stack(keep_k, -1), c)


def _dispatch(xg, top_i, pos, keep, e, c):
    """Each expert's slots, (E, G * C, D): slot (e, g, j) holds the row of
    group g's token routed to expert e at position j, or zeros. A kept
    assignment writes its token's row index into its slot; a dropped one
    writes into a spare slot past C, which is cut off."""
    g, s, d = xg.shape
    dev = xg.device
    gi = torch.arange(g, device=dev)[:, None]
    src = gi * (s + 1) + torch.arange(s, device=dev)     # a token's padded row
    idx = (gi * (s + 1) + s).expand(g, c + 1)            # the zero row
    idx = idx[None].expand(e, g, c + 1).contiguous()
    flat = idx.view(-1)
    for kk in range(top_i.shape[-1]):
        slot = torch.where(keep[..., kk], pos[..., kk], c)
        flat.scatter_(0, (top_i[..., kk] * g * (c + 1) + gi * (c + 1)
                          + slot).reshape(-1), src.reshape(-1))
    idx = idx[..., :c].reshape(-1)
    x_pad = torch.cat([xg, xg.new_zeros(g, 1, d)], dim=1).reshape(-1, d)
    return x_pad.index_select(0, idx).reshape(e, g * c, d)


def _combine(ex_out, top_i, top_p, pos, keep, mc, dtype):
    """ex_out (E, G * C, D) -> each token's (G, S, D) sum over its k slots,
    each slot row weighted by its renormalised probability (0 where the
    assignment was dropped), in f32, rounded once to dtype. einsum mode
    rounds the weights to dtype first, as the reference's combine tensor
    holds them."""
    e, gc, d = ex_out.shape
    g, s, k = top_i.shape
    c = gc // g
    rows = ex_out.reshape(e * gc, d)
    gi = torch.arange(g, device=ex_out.device)[:, None]
    out = None
    for kk in range(k):
        row = top_i[..., kk] * gc + gi * c + pos[..., kk].clamp(0, c - 1)
        slot = rows.index_select(0, row.reshape(-1)).reshape(g, s, d).float()
        w = torch.where(keep[..., kk], top_p[..., kk], 0.0)
        if mc.dispatch == "einsum":
            w = w.to(dtype).float()
        term = slot * w[..., None]
        out = term if out is None else out + term
    return out.to(dtype)


def moe_apply(p, x, cfg, *, aux=None, drops=None):
    """x (B, T, D) -> the MoE FFN's output (B, T, D), without the block's
    residual (the block adds x). aux: a dict to add this layer's
    "moe_lb_loss", "moe_z_loss" (each times its coefficient) and
    "moe_dropped_frac" into, or None to compute none of them. drops: a
    list to append this layer's dropped assignments of each token to,
    (B, T) int32, or None."""
    mc = cfg.moe
    if mc.dispatch not in DISPATCH_MODES:
        raise ValueError(f"unknown moe dispatch {mc.dispatch!r}; expected "
                         f"one of {DISPATCH_MODES}")
    b, t, d = x.shape
    e = mc.n_experts
    s = group_size(mc, b * t)
    g = b * t // s
    xg = x.reshape(g, s, d)
    logits, probs, top_p, top_i, pos, keep, c = _route(p, xg, mc)

    ex_in = _dispatch(xg, top_i, pos, keep, e, c)
    # the expert SwiGLU: the batched dual GEMM, then the batched down GEMM
    h = gemm.gated_mlp(ex_in, p["w_gate"].to(x.dtype),
                       p["w_up"].to(x.dtype))
    ex_out = gemm.matmul(h, p["w_down"].to(x.dtype))
    out = _combine(ex_out, top_i, top_p, pos, keep, mc,
                   x.dtype).reshape(b, t, d)

    if mc.dense_ff:               # Arctic: the parallel dense branch
        out = out + F.mlp_apply(p["dense"], x, cfg)
    if drops is not None:
        drops.append((~keep).sum(-1, dtype=torch.int32).reshape(b, t))

    if aux is not None:
        me = probs.mean((0, 1))
        ce = (top_i[..., 0, None] == torch.arange(e, device=x.device)) \
            .float().mean((0, 1))
        terms = {
            "moe_lb_loss": e * (me * ce).sum() * mc.load_balance_coef,
            "moe_z_loss": (torch.logsumexp(logits, -1) ** 2).mean()
            * mc.router_z_coef,
            "moe_dropped_frac": 1.0 - keep.float().mean(),
        }
        for name, v in terms.items():
            aux[name] = aux[name] + v if name in aux else v
    return out
