"""Attention layer: GQA, qk-norm, RoPE, dense or paged KV cache.

Three paths:
  * a one-token decode step on a dense cache goes to the flash_decode
    kernel, which reads each slot's cache prefix in place;
  * a one-token decode step on a page pool (`kv_table` given) goes to
    the flash_decode_paged kernel, which reads each slot's pages in
    place through the table;
  * everything else (prefill into the cache) takes `chunked_attention`,
    an online softmax over KV chunks in plain PyTorch, as the JAX
    package runs it in plain XLA.

The KV cache is updated in place: the JAX package writes a new cache
and donates the old one; here the written rows land in the caller's
tensors, which saves a copy of the cache a step.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import precision
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L


def chunked_attention(q, k, v, *, window=None, chunk=2048, q_offset=0,
                      kv_len=None, io_dtype=torch.float32):
    """Causal online-softmax attention over KV chunks. q [B, Tq, H, D]
    against k/v [B, Tk, Hkv, D]; query row i sits at position q_offset + i
    and sees keys below kv_len (ints: every row of the batch at one
    offset)."""
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
        mask = k_pos <= q_pos
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


def attention(q, k, v, *, window, chunk, q_offset=0, kv_len=None,
              io_dtype=torch.float32, decode: bool = False):
    """The attention chokepoint: a decode step (t == 1, kv_len = pos + 1)
    runs the flash_decode kernel; every other case the chunked path."""
    if decode and q.shape[1] == 1:
        return kops.flash_decode(q, k, v, pos=q_offset, window=window)
    return chunked_attention(q, k, v, window=window, chunk=chunk,
                             q_offset=q_offset, kv_len=kv_len,
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


def _project_kv(p, x, cfg):
    b, t, _ = x.shape
    dh = cfg.resolved_head_dim
    k = L.dense_apply(p["wk"], x).reshape(b, t, cfg.n_kv_heads, dh)
    v = L.dense_apply(p["wv"], x).reshape(b, t, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        k = L.rmsnorm_apply(p["k_norm"], k)      # before RoPE
    return k, v


def _write_rows(cache, k, v, pos):
    """Write each slot's new row at its own position. A slot with pos < 0
    is idle, and a position past the cache is dropped, as the JAX
    package's scatter drops it: such a slot's row is rewritten with its
    own old value, so no host sync is needed to find the active slots."""
    tmax = cache["k"].shape[1]
    pos = pos.to(k.device, torch.long)
    keep = ((pos >= 0) & (pos < tmax))[:, None, None]
    bidx = torch.arange(k.shape[0], device=k.device)
    widx = pos.clamp(0, tmax - 1)
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        c[bidx, widx] = torch.where(keep, new[:, 0].to(c.dtype), c[bidx, widx])


def _write_pages(pool, table, k, v, pos):
    """Write each slot's new row at (table[b, pos // ps], pos % ps) of the
    layer's pool, quantized on an int8 pool (scales into ks/vs[phys, :,
    off]). A slot with pos < 0, pos past the table or an unmapped (-1)
    write page writes nothing, as the JAX package's scatter with
    mode="drop" writes nothing. Without a host sync: each dropped slot
    repeats the write of one donor slot (the first kept one, or slot 0
    rewriting its own old values when none is kept), so every duplicated
    index carries one value and the scatter is deterministic; kept slots
    write private pages (the engine's prepare_write), so theirs differ."""
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
               kv_table=None):
    """Returns (out, cache). cache: {"k", "v"} [B, Tmax, Hkv, Dh], updated
    in place at cache_pos: an int (every row at one offset, a slice
    update) or, for a one-token step, a (B,) vector of per-slot positions
    (continuous batching; pos < 0 = idle slot, its rows untouched).
    With kv_table (B, pp), cache is the layer's page pool {"k", "v":
    [P, page_size, Hkv, Dh][, "ks", "vs": [P, Hkv, page_size]]}, and the
    step is one token a slot at a per-slot cache_pos."""
    b, t, _ = x.shape
    dh = cfg.resolved_head_dim
    q = L.dense_apply(p["wq"], x).reshape(b, t, cfg.n_heads, dh)
    if cfg.qk_norm:
        q = L.rmsnorm_apply(p["q_norm"], q)
    io_dtype = torch.float32 if cfg.attn_f32_io else torch.bfloat16
    k, v = _project_kv(p, x, cfg)

    pos_vec = isinstance(cache_pos, torch.Tensor) and cache_pos.dim() == 1
    if pos_vec and t != 1:
        raise ValueError(f"a per-slot cache_pos takes one token a slot, "
                         f"got {t}")
    if kv_table is not None and not pos_vec:
        raise ValueError("a paged KV cache takes a per-slot cache_pos")
    positions = L.default_positions(
        b, t, cache_pos if cache_pos is not None else 0, device=x.device)
    if cfg.use_rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and kv_table is not None:
        _write_pages(cache, kv_table, k, v, cache_pos)
        out = kops.flash_decode_paged(q, cache["k"], cache["v"], kv_table,
                                      pos=cache_pos, window=cfg.window,
                                      ks=cache.get("ks"), vs=cache.get("vs"))
    elif cache is not None and pos_vec:
        _write_rows(cache, k, v, cache_pos)
        out = attention(q, cache["k"], cache["v"], window=cfg.window,
                        chunk=cfg.attn_chunk, q_offset=cache_pos,
                        io_dtype=io_dtype, decode=True)
    elif cache is not None:
        pos = int(cache_pos)
        cache["k"][:, pos:pos + t] = k.to(cache["k"].dtype)
        cache["v"][:, pos:pos + t] = v.to(cache["v"].dtype)
        out = attention(q, cache["k"], cache["v"], window=cfg.window,
                        chunk=cfg.attn_chunk, q_offset=pos, kv_len=pos + t,
                        io_dtype=io_dtype, decode=(t == 1))
    else:
        out = attention(q, k, v, window=cfg.window, chunk=cfg.attn_chunk,
                        io_dtype=io_dtype)

    out = out.reshape(b, t, cfg.n_heads * dh)
    return L.dense_apply(p["wo"], out), cache
