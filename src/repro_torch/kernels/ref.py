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
    """C = A @ B with f32 accumulation (f64 for f64 inputs): also the
    plain version of the naive GEMM."""
    out_dtype = out_dtype or a.dtype
    acc = _acc_dtype(a.dtype)
    return torch.matmul(a.to(acc), b.to(acc)).to(out_dtype)


def dequantize_ref(wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The float weight from int8 + per-channel scale."""
    return wq.to(scale.dtype) * scale


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


def matmul_q_ref(a, wq, scale, out_dtype=None, epilogue="none", bias=None,
                 residual=None) -> torch.Tensor:
    """What the int8-weight kernel computes: A @ Wq on an f32 accumulator
    (int8 values are exact in bf16 and f32), the (N,) per-channel scale
    applied to the accumulator, then the epilogue, then one rounding to
    `out_dtype`."""
    out_dtype = out_dtype or a.dtype
    acc_dtype = _acc_dtype(a.dtype)
    acc = torch.matmul(a.to(acc_dtype), wq.to(acc_dtype))
    acc = acc * scale.reshape(1, -1).to(acc_dtype)
    return epilogue_ref(acc, epilogue, bias, residual).to(out_dtype)


def gated_matmul_ref(a, w_gate, w_up) -> torch.Tensor:
    """silu(A @ Wg) * (A @ Wu) with f32 accumulation, the gate product
    taken in the accumulator's dtype and rounded once to A's."""
    acc = _acc_dtype(a.dtype)
    g = torch.matmul(a.to(acc), w_gate.to(acc))
    u = torch.matmul(a.to(acc), w_up.to(acc))
    return (F.silu(g) * u).to(a.dtype)


def add_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def sub_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - b


BINARY_OPS = {"add": add_ref, "sub": sub_ref, "mul": torch.mul}


def binary_ref(a: torch.Tensor, b: torch.Tensor, op: str = "add") -> torch.Tensor:
    """C = A op B in A's dtype, op in add, sub and mul: what the
    elementwise kernel computes."""
    if op not in BINARY_OPS:
        raise ValueError(f"unknown op {op!r}; expected one of "
                         f"{tuple(BINARY_OPS)}")
    return BINARY_OPS[op](a, b)


def saxpy_ref(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """alpha * x + y in x's dtype, with alpha (a number, or a one-element
    tensor) cast to x's dtype first, as the JAX kernel casts it; the
    product and the sum are rounded each."""
    a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device).reshape(())
    return a * x + y


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


_LSE_EMPTY = 1e30     # logsumexp of a row that sees no key


def _attention_logits(q, k, *, causal, window):
    """Scaled, masked logits [B, H, Tq, Tk] (f32, -1e30 where masked),
    the (Tq, Tk) mask, the GQA group and the scaled f32 q."""
    tq, h, d = q.shape[1:]
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qs = q.float() * d ** -0.5
    kf = k.float().repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    q_pos = torch.arange(tq, device=q.device)[:, None]
    k_pos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return torch.where(mask, logits, torch.full_like(logits, -1e30)), mask, g, qs


def flash_attention_fwd_ref(q, k, v, *, causal=True, window=None):
    """Softmax attention of q [B, Tq, H, D] over k/v [B, Tk, Hkv, D] (GQA:
    query head h reads kv head h // (H // Hkv)); query row i sees keys
    j <= i under `causal` and j > i - window with a window. Returns
    (o [B, Tq, H, D] in q's dtype, lse [B, H, Tq] f32): a row that sees
    no key gets lse = 1e30 and o = 0, as the flash kernels give it."""
    logits, mask, g, _ = _attention_logits(q, k, causal=causal, window=window)
    lse = torch.where(mask.any(-1), torch.logsumexp(logits, dim=-1),
                      torch.full_like(logits[..., 0], _LSE_EMPTY))
    p = torch.exp(logits - lse[..., None])
    vf = v.float().repeat_interleave(g, dim=2)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, o, do, lse, *, causal=True, window=None):
    """The closed-form backward of `flash_attention_fwd_ref` from its
    (o, lse) residuals and the output's cotangent do: P = exp(S - lse),
    dV = Pᵀ dO, dS = P (dO Vᵀ - rowsum(dO O)), dK = dSᵀ qs,
    dQ = D^-0.5 dS K, with dK and dV summed over each KV head's group of
    query heads. Returns (dq, dk, dv) in the input dtypes."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    logits, _, g, qs = _attention_logits(q, k, causal=causal, window=window)
    p = torch.exp(logits - lse.float()[..., None])         # (B, H, Tq, Tk)
    dof, of = do.float(), o.float()
    vf = v.float().repeat_interleave(g, dim=2)
    kf = k.float().repeat_interleave(g, dim=2)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)            # per query head
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * of).sum(-1)                               # (B, Tq, H)
    ds = p * (dp - delta.transpose(1, 2)[..., None])
    dq = d ** -0.5 * torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    dk = dk.reshape(b, tk, hkv, g, d).sum(3)
    dv = dv.reshape(b, tk, hkv, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def paged_gather_ref(kp, table, scales=None):
    """Each slot's logical K/V from a page pool: logical page j of slot b
    is pool page table[b, j]. kp [P, page_size, Hkv, D]; table [B, pp],
    -1 unmapped (clamped to page 0, which the caller's causal mask
    hides); scales [P, Hkv, page_size] f32 for an int8 pool, which is
    then dequantized in f32. Returns [B, pp * page_size, Hkv, D]."""
    b, pp = table.shape
    _, ps, hkv, d = kp.shape
    idx = table.long().clamp(min=0)
    gathered = kp[idx]                                # (B, pp, ps, Hkv, D)
    if scales is not None:
        s = scales[idx]                               # (B, pp, Hkv, ps)
        gathered = gathered.float() * s.transpose(2, 3)[..., None]
    return gathered.reshape(b, pp * ps, hkv, d)


def flash_decode_paged_ref(q, kp, vp, table, *, pos=0, window=None,
                           ks=None, vs=None):
    """Decode attention through a page table: gather (and dequantize)
    each slot's pages, then `attention_fwd_ref` at q_offset=pos.
    q [B, 1, H, D]; returns [B, 1, H, D] in q's dtype."""
    k = paged_gather_ref(kp, table, ks)
    v = paged_gather_ref(vp, table, vs)
    return attention_fwd_ref(q, k, v, window=window, q_offset=pos)


# ----------------------------------------------------------------------
# SSD (Mamba-2 state-space duality)
# ----------------------------------------------------------------------

def segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q) -> (..., Q, Q) with S[i, j] = sum_{j < m <= i} a[..., m],
    -inf above the diagonal: the log-space decay mask, masked before any
    exp."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    s = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return s.masked_fill(~keep, float("-inf"))


def ssd_chunked_ref(x, a, b, c, chunk: int, init_state=None):
    """The chunked SSD scan, as the JAX package's `ssd_chunked`.
    x (B, L, H, P) dt-scaled, a (B, L, H) log-decays, b/c (B, L, G, N),
    init_state (B, H, P, N) or None. Every interior value, the carried
    inter-chunk state included, is f32 (f64 for f64 x). Returns (y in
    x's dtype, final_state (B, H, P, N) f32)."""
    bsz, l, h, p = x.shape
    g, n = b.shape[-2:]
    rep = h // g
    nc = l // chunk
    acc = _acc_dtype(x.dtype)
    xc = x.to(acc).reshape(bsz, nc, chunk, h, p)
    ac = a.to(acc).reshape(bsz, nc, chunk, h).transpose(2, 3)  # (B,nc,H,Q)
    bc = b.to(acc).reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, 3)
    cc = c.to(acc).reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, 3)

    # 1. intra-chunk: the decay-masked blocked product
    ldec = torch.exp(segsum(ac))                              # (B,nc,H,Q,Q)
    cb = torch.einsum("bcqhn,bcshn->bchqs", cc, bc)
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", cb * ldec, xc)

    # 2. each chunk's state
    a_cum = torch.cumsum(ac, dim=-1)                          # (B,nc,H,Q)
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)
    states = torch.einsum("bcqhn,bchq,bcqhp->bchpn", bc, decay_to_end, xc)

    # 3. inter-chunk recurrence, seeded by init_state
    chunk_decay = torch.exp(a_cum[..., -1])                   # (B,nc,H)
    s = (torch.zeros((bsz, h, p, n), dtype=acc, device=x.device)
         if init_state is None else init_state.to(acc))
    prev = []
    for ci in range(nc):
        prev.append(s)                                        # state *before*
        s = s * chunk_decay[:, ci, :, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)                    # (B,nc,H,P,N)

    # 4. state -> output within each chunk
    state_decay = torch.exp(a_cum)
    y_off = torch.einsum("bcqhn,bchpn,bchq->bcqhp", cc, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(bsz, l, h, p).to(x.dtype)
    return y, s


def ssd_intra_chunk_ref(x, a, b, c, chunk: int):
    """What the SSD kernel computes, chunk by chunk, in f32: with
    cs = cumsum(a) over a chunk and head h reading group h // (H / G),
        y_diag[i] = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) x_j
        state     = sum_j (B_j exp(cs_last - cs_j))^T x_j       (N, P)
    for x (B, L, H, P), a (B, L, H), b/c (B, L, G, N), L a multiple of
    chunk. Returns (y_diag (B, L, H, P) f32, states (B, H, nc, N, P)
    f32)."""
    bsz, l, h, p = x.shape
    g, n = b.shape[-2:]
    rep = h // g
    nc = l // chunk
    f = torch.float32
    xc = x.to(f).reshape(bsz, nc, chunk, h, p)
    ac = a.to(f).reshape(bsz, nc, chunk, h).transpose(2, 3)    # (B,nc,H,Q)
    bc = b.to(f).reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, 3)
    cc = c.to(f).reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, 3)
    scores = torch.einsum("bcqhn,bcshn->bchqs", cc, bc) \
        * torch.exp(segsum(ac))
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", scores, xc)
    cs = torch.cumsum(ac, dim=-1)
    decay_end = torch.exp(cs[..., -1:] - cs)                    # (B,nc,H,Q)
    states = torch.einsum("bcqhn,bchq,bcqhp->bhcnp", bc, decay_end, xc)
    return y_diag.reshape(bsz, l, h, p), states


def ssd_seq_ref(x, a, b, c, chunk: int = 0, init_state=None):
    """The sequential per-token SSD oracle, as the JAX package's
    `ssd_ref`: s_t = s_{t-1} exp(a_t) + x_t b_t^T, y_t = s_t c_t, in f32
    (f64 for f64 x) with no chunking (`chunk` is accepted for the
    signature and ignored). Returns (y in x's dtype, final_state (B, H,
    P, N))."""
    bsz, l, h, p = x.shape
    g, n = b.shape[-2:]
    rep = h // g
    acc = _acc_dtype(x.dtype)
    xf, af = x.to(acc), a.to(acc)
    bf = b.to(acc).repeat_interleave(rep, 2)                  # (B,L,H,N)
    cf = c.to(acc).repeat_interleave(rep, 2)
    s = (torch.zeros((bsz, h, p, n), dtype=acc, device=x.device)
         if init_state is None else init_state.to(acc))
    ys = []
    for t in range(l):
        s = s * torch.exp(af[:, t])[..., None, None] \
            + xf[:, t, :, :, None] * bf[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhpn->bhp", cf[:, t], s))
    return torch.stack(ys, dim=1).to(x.dtype), s
