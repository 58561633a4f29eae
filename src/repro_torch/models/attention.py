"""Attention layer: GQA, qk-norm, RoPE, dense or paged KV cache, and
cross-attention over an encoder's K/V (Whisper).

The paths:
  * cache-less self-attention (the training forward; causal, or not in
    an encoder) goes to the flash_attention kernel through
    `_AttentionFused`, whose backward is the flash_attention_bwd kernel,
    as the JAX package's `_attention_fused` custom VJP routes it; the
    kernel takes any T (JAX routes only T its blocks divide,
    `_flash_shapes_ok`, and the rest to the chunked path);
  * cross-attention (`enc_kv`) over the whole encoder output: at
    prefill the non-causal flash_attention kernel (Tq != Tk); at a
    decode step (`cross_pos` given) the flash_decode kernel over each
    slot's encoder keys, its position the last key's (-1: an idle slot,
    a zero row);
  * a decode step on a dense cache (one token a slot at a per-slot
    position), or a speculative verify step (t tokens a slot, n_valid of
    them real), goes to the flash_decode kernel, which reads each slot's
    cache prefix in place; row r of a verify step is the decode step's
    result at pos + r, bit for bit;
  * the same on a page pool (`kv_table` given) goes to the
    flash_decode_paged kernel, which reads each slot's pages in place
    through the table;
  * prefill into a cache takes `chunked_attention`, an online softmax
    over KV chunks in plain PyTorch, as the JAX package runs masked
    prefill in plain XLA.

The KV cache is updated in place: the JAX package writes a new cache
and donates the old one; here the written rows land in the caller's
tensors, which saves a copy of the cache a step.

Under a "model" group (`distributed.context.model_group`) the layer is
tensor-parallel over heads: Q, K and V are column-parallel over this
rank's heads (one `core.distributed.copy_to` of the input shared by the
three, its cotangent all-reduced backward), attention and the cache see
the local heads alone, and O is row-parallel, its bias added once after
the sum (`layers.row_parallel_apply`). K/V heads that do not divide over
the group (MQA) are replicated, each rank taking the one its query heads
read; the replicated K/V weights and the q/k norms' scales, whose
gradients each rank holds in part, go through `copy_to` too. The head
counts come from the weights' shapes, so without a group every path is
as before.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import distributed as D
from repro_torch.core import precision
from repro_torch.distributed import context as ctx
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


def chunked_attention(q, k, v, *, causal=True, window=None, chunk=2048,
                      q_offset=0, kv_len=None, io_dtype=torch.float32):
    """Online-softmax attention over KV chunks. q [B, Tq, H, D] against
    k/v [B, Tk, Hkv, D]; query row i sits at position q_offset + i and
    sees the keys at or before it (all of them without `causal`) below
    kv_len (ints: every row of the batch at one offset)."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    chunk = min(chunk, tk)
    if tk % chunk:
        raise ValueError(f"kv length {tk} is not a multiple of chunk {chunk}")
    dev = q.device
    qf = (q.to(io_dtype) * torch.tensor(d ** -0.5, dtype=io_dtype)) \
        .reshape(b, tq, hkv, g, d)
    kf, vf = k.to(io_dtype), v.to(io_dtype)
    q_pos = torch.arange(tq, device=dev)[None, :, None] + q_offset

    m = torch.full((b, tq, hkv, g), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((b, tq, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, tq, hkv, g, d), dtype=torch.float32, device=dev)
    for c0 in range(0, tk, chunk):
        kc, vc = kf[:, c0:c0 + chunk], vf[:, c0:c0 + chunk]
        s = torch.einsum("bqkgd,bckd->bqkgc", qf, kc).float()
        k_pos = c0 + torch.arange(chunk, device=dev)[None, None, :]
        mask = k_pos <= q_pos if causal else \
            torch.ones_like(k_pos, dtype=torch.bool)
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        if kv_len is not None:
            mask = mask & (k_pos < kv_len)
        s = torch.where(mask[:, :, None, None, :], s,
                        torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(vc.dtype), vc).float()
        m = m_new
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l[..., None]).reshape(b, tq, h, d)
    return out.to(q.dtype)


class _AttentionFused(torch.autograd.Function):
    """Attention of q [B, Tq, H, D] over k/v [B, Tk, Hkv, D] (causal, or
    not), the counterpart of `_attention_fused`: the forward is the flash
    kernel with its logsumexp, saved with the output; the backward is the
    two-sweep flash_attention_bwd kernel on those residuals."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        o, lse = kops.flash_attention_fwd(q, k, v, causal=causal,
                                          window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.causal = window, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = kops.flash_attention_bwd(
            q, k, v, o, do.contiguous(), lse, causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def attention(q, k, v, *, window, chunk, q_offset=0, kv_len=None,
              io_dtype=torch.float32, decode: bool = False,
              causal: bool = True):
    """The attention chokepoint of the contiguous paths: a one-token step
    at an int position (kv_len = pos + 1) runs the flash_decode kernel;
    cache-less attention (no kv_len, q_offset 0: self-attention, causal
    or not, and cross-attention at prefill) the flash_attention kernel
    and its backward; prefill into a cache the chunked path. (The
    per-slot paths call the decode kernels themselves.)"""
    if decode and q.shape[1] == 1:
        return kops.flash_decode(q, k, v, pos=q_offset, window=window)
    if kv_len is None and isinstance(q_offset, int) and q_offset == 0:
        return _AttentionFused.apply(q, k, v, window, causal)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             chunk=chunk, q_offset=q_offset, kv_len=kv_len,
                             io_dtype=io_dtype)


def attn_init(generator, cfg, *, device):
    d, dh = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    dtype = getattr(torch, cfg.param_dtype)
    kw = dict(dtype=dtype, device=device, bias=cfg.qkv_bias)
    p = {
        "wq": L.dense_init(generator, d, h * dh, **kw),
        "wk": L.dense_init(generator, d, hkv * dh, **kw),
        "wv": L.dense_init(generator, d, hkv * dh, **kw),
        "wo": L.dense_init(generator, h * dh, d, dtype=dtype, device=device,
                           scale=(h * dh) ** -0.5 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(dh, dtype=dtype, device=device)
        p["k_norm"] = L.rmsnorm_init(dh, dtype=dtype, device=device)
    return p


def project_cross_kv(p, enc_out, cfg):
    """The encoder output [B, Tenc, d] projected to cross-attention's
    (k, v), each [B, Tenc, Hkv, Dh] (Whisper)."""
    return _project_kv(p, enc_out, cfg)


def _project_kv(p, x, cfg):
    b, t, _ = x.shape
    dh = cfg.resolved_head_dim
    k = L.dense_apply(p["wk"], x).reshape(b, t, -1, dh)
    v = L.dense_apply(p["wv"], x).reshape(b, t, -1, dh)
    if cfg.qk_norm:
        k = L.rmsnorm_apply(p["k_norm"], k)      # before RoPE
    return k, v


def _tp_params(p, cfg, group):
    """(p with its partly-graded replicated leaves through `copy_to`, the
    KV head a rank reads from replicated K/V or None)."""
    tp = D._size(group)
    p = dict(p)
    for name in ("q_norm", "k_norm"):
        if name in p:
            p[name] = {k: D.copy_to(v, group) for k, v in p[name].items()}
    if cfg.n_kv_heads % tp == 0:
        return p, None
    for name in ("wk", "wv"):
        p[name] = {k: D.copy_to(v, group) for k, v in p[name].items()}
    return p, D._rank(group) // (tp // cfg.n_kv_heads)


def _row_positions(pos, t: int, n_valid, device):
    """The positions pos[b] + r of each slot's t new rows, (B, t) long, and
    the mask of the real ones: pos >= 0 and r < n_valid[b] (all t rows
    without n_valid)."""
    pos = pos.to(device, torch.long)[:, None]
    r = torch.arange(t, device=device)[None]
    n = t if n_valid is None else n_valid.to(device)[:, None]
    return pos + r, (pos >= 0) & (r < n)


def _scatter_rows(c, idx, keep, new) -> None:
    """c[idx] = new where keep, for a tuple `idx` of (N,) index tensors
    (and slices) and an (N,) mask: the rows keep drops are written
    nowhere, as the JAX package's scatter with mode="drop" writes them.
    Without a host sync: each dropped row repeats the write of one donor
    row (the first kept one, or row 0 rewriting its own old value when
    none is kept), so every duplicated index carries one value and the
    scatter is deterministic; kept rows write distinct places."""
    n = keep.shape[0]
    donor = torch.argmax(keep.to(torch.int8))
    sel = torch.where(keep, torch.arange(n, device=keep.device), donor)
    old = c[idx]
    val = torch.where(keep.view(n, *([1] * (old.dim() - 1))),
                      new.to(c.dtype), old)
    c[tuple(i[sel] if isinstance(i, torch.Tensor) else i
            for i in idx)] = val[sel]


def _write_rows(cache, k, v, pos, n_valid=None):
    """Write slot b's new rows r = 0 .. t - 1 at positions pos[b] + r of
    its cache row. A slot with pos < 0 is idle; rows r >= n_valid[b] and
    positions past the cache are dropped (`_scatter_rows`). One row a
    slot (a decode step) takes the short path: each slot writes its own
    place, a dropped slot its own old value, so no place is written
    twice and no donor is needed."""
    b, t = k.shape[:2]
    tmax = cache["k"].shape[1]
    if t == 1 and n_valid is None:
        pos = pos.to(k.device, torch.long)
        keep = ((pos >= 0) & (pos < tmax))[:, None, None]
        bidx = torch.arange(b, device=k.device)
        widx = pos.clamp(0, tmax - 1)
        for name, new in (("k", k), ("v", v)):
            c = cache[name]
            c[bidx, widx] = torch.where(keep, new[:, 0].to(c.dtype),
                                        c[bidx, widx])
        return
    wpos, keep = _row_positions(pos, t, n_valid, k.device)
    keep = (keep & (wpos < tmax)).reshape(-1)
    bidx = torch.arange(b, device=k.device).repeat_interleave(t)
    widx = wpos.reshape(-1).clamp(0, tmax - 1)
    for name, new in (("k", k), ("v", v)):
        _scatter_rows(cache[name], (bidx, widx), keep,
                      new.reshape(b * t, *new.shape[2:]))


def _write_pages(pool, table, k, v, pos, n_valid=None):
    """Write slot b's new rows r = 0 .. t - 1 at (table[b, p // ps], p % ps)
    of the layer's pool, p = pos[b] + r, quantized on an int8 pool (scales
    into ks/vs[phys, :, off]). A slot with pos < 0, rows r >= n_valid[b],
    a position past the table and an unmapped (-1) page write nothing
    (`_scatter_rows`); kept rows write private pages (the engine's
    prepare_write), so no two of them meet. One row a slot (a decode
    step) takes the short path of the same rule."""
    b, t = k.shape[:2]
    ps = pool["k"].shape[1]
    pp = table.shape[1]
    if t == 1 and n_valid is None:
        _write_page_rows(pool, table, k, v, pos)
        return
    wpos, keep = _row_positions(pos, t, n_valid, k.device)
    bidx = torch.arange(b, device=k.device)[:, None]
    j = (wpos.clamp(min=0) // ps).clamp(max=pp - 1)
    phys = table[bidx, j].long()
    keep = (keep & (wpos < pp * ps) & (phys >= 0)).reshape(-1)
    phys = phys.clamp(min=0).reshape(-1)
    off = (wpos.clamp(min=0) % ps).reshape(-1)
    rows = {"k": k.reshape(b * t, *k.shape[2:]),
            "v": v.reshape(b * t, *v.shape[2:])}          # (B t, Hkv, D)
    if "ks" in pool:
        for name in ("k", "v"):
            q, s = precision.quantize_kv(rows[name])      # s: (B t, Hkv)
            rows[name], rows[name + "s"] = q, s
    for name, new in rows.items():
        idx = (phys, slice(None), off) if name in ("ks", "vs") \
            else (phys, off)
        _scatter_rows(pool[name], idx, keep, new)


def _write_page_rows(pool, table, k, v, pos):
    """`_write_pages` for one row a slot, in fewer ops: each dropped slot
    repeats the write of one donor slot (the first kept one, or slot 0
    rewriting its own old values when none is kept)."""
    ps = pool["k"].shape[1]
    nb, pp = table.shape
    pos = pos.to(k.device, torch.long)
    bidx = torch.arange(nb, device=k.device)
    j = (pos.clamp(min=0) // ps).clamp(max=pp - 1)
    phys = table[bidx, j].long()
    keep = (pos >= 0) & (pos < pp * ps) & (phys >= 0)
    phys, off = phys.clamp(min=0), pos.clamp(min=0) % ps
    donor = torch.argmax(keep.to(torch.int8))
    sel = torch.where(keep, bidx, donor)
    wp, wo = phys[sel], off[sel]
    rows = {"k": k[:, 0], "v": v[:, 0]}                   # (B, Hkv, D)
    if "ks" in pool:
        for name in ("k", "v"):
            q, s = precision.quantize_kv(rows[name])      # s: (B, Hkv)
            rows[name], rows[name + "s"] = q, s
    for name, new in rows.items():
        c = pool[name]
        if name in ("ks", "vs"):
            old = c[phys, :, off]
            c[wp, :, wo] = torch.where(keep[:, None], new, old)[sel]
        else:
            old = c[phys, off]
            c[wp, wo] = torch.where(keep[:, None, None], new.to(c.dtype),
                                    old)[sel]


def attn_apply(p, x, cfg, *, cache: Optional[dict] = None, cache_pos=None,
               kv_table=None, n_valid=None, positions=None, causal=True,
               enc_kv=None, cross_pos=None):
    """Returns (out, cache). positions: the RoPE positions of x's tokens,
    (B, T), or (B, T, 3) M-RoPE streams (cfg.mrope_sections); None: token
    r of row b at cache_pos (+ r), or at r without a cache. They turn q
    and k only: the cache is written at cache_pos all the same, as the
    JAX package writes it. Without a cache: causal self-attention over
    x's own tokens (training). cache: {"k", "v"} [B, Tmax, Hkv, Dh],
    updated in place at cache_pos: an int (every row at one offset, a slice
    update) or a (B,) vector of per-slot positions (continuous batching;
    pos < 0 = idle slot, its rows untouched): token r of slot b at
    pos[b] + r, and with n_valid (B,) only its first n_valid[b] tokens
    written and attended (a verify step). With kv_table (B, pp), cache is
    the layer's page pool {"k", "v": [P, page_size, Hkv, Dh][, "ks",
    "vs": [P, Hkv, page_size]]}, at a per-slot cache_pos. causal=False:
    cache-less attention over all of x's tokens (an encoder).

    enc_kv: cross-attention, x's queries over the encoder's (k, v)
    [B, Tenc, Hkv, Dh] (no RoPE, no cache write): every key without
    `cross_pos` (prefill, the training forward), or through the decode
    kernel at cross_pos, an int or a (B,) vector of Tenc - 1 (-1 for an
    idle slot, whose row is zeros)."""
    b, t, _ = x.shape
    dh = cfg.resolved_head_dim
    group, kv_head = ctx.model_group(), None
    if group is not None:
        p, kv_head = _tp_params(p, cfg, group)
        x = D.copy_to(x, group)
    q = L.dense_apply(p["wq"], x).reshape(b, t, -1, dh)
    if cfg.qk_norm:
        q = L.rmsnorm_apply(p["q_norm"], q)
    io_dtype = torch.float32 if cfg.attn_f32_io else torch.bfloat16
    if enc_kv is not None:
        k, v = enc_kv
        if cross_pos is None:
            out = attention(q, k, v, window=None, chunk=cfg.attn_chunk,
                            io_dtype=io_dtype, causal=False)
        else:
            out = kops.flash_decode(q, k, v, pos=cross_pos)
        return L.dense_apply(p["wo"], out.reshape(b, t, -1)), None
    k, v = _project_kv(p, x, cfg)
    if kv_head is not None:
        k, v = k[:, :, kv_head:kv_head + 1], v[:, :, kv_head:kv_head + 1]

    pos_vec = isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1
    if (kv_table is not None or n_valid is not None) and not pos_vec:
        raise ValueError("a paged KV cache and n_valid take a per-slot "
                         "cache_pos")
    if positions is None:
        positions = L.default_positions(
            b, t, cache_pos if cache_pos is not None else 0, device=x.device)
    if cfg.use_rope:
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    if cache is not None and kv_table is not None:
        _write_pages(cache, kv_table, k, v, cache_pos, n_valid)
        out = kops.flash_decode_paged(q, cache["k"], cache["v"], kv_table,
                                      pos=cache_pos, window=cfg.window,
                                      ks=cache.get("ks"), vs=cache.get("vs"),
                                      n_valid=n_valid)
    elif cache is not None and pos_vec:
        _write_rows(cache, k, v, cache_pos, n_valid)
        out = kops.flash_decode(q, cache["k"], cache["v"], pos=cache_pos,
                                window=cfg.window, n_valid=n_valid)
    elif cache is not None:
        pos = int(cache_pos)
        cache["k"][:, pos:pos + t] = k.to(cache["k"].dtype)
        cache["v"][:, pos:pos + t] = v.to(cache["v"].dtype)
        out = attention(q, cache["k"], cache["v"], window=cfg.window,
                        chunk=cfg.attn_chunk, q_offset=pos, kv_len=pos + t,
                        io_dtype=io_dtype, decode=(t == 1))
    else:
        out = attention(q, k, v, window=cfg.window, chunk=cfg.attn_chunk,
                        io_dtype=io_dtype, causal=causal)

    out = out.reshape(b, t, -1)
    if group is not None:
        return L.row_parallel_apply(p["wo"], out, group), cache
    return L.dense_apply(p["wo"], out), cache
