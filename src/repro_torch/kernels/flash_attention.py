"""Wrappers of the attention CUDA kernels (`csrc/flash_attention.cu`,
`csrc/flash_decode.cu`).

`flash_attention` and `flash_attention_bwd` (training: the forward with
its logsumexp residual, and the two-sweep backward), `flash_decode` and
`flash_decode_paged` (serving) replace the Pallas kernels of the same
names in the JAX package. They keep the model's layouts: q [B, Tq, H, D]
against k/v [B, Tk, Hkv, D], the dense cache, or a page pool
[P, page_size, Hkv, D] through a page table [B, pp] (-1 unmapped), all
read in place through their strides. Each takes tensors on the card and
launches its kernel, or raises; the CPU paths are the plain versions in
`kernels.ref`, chosen by `kernels.ops`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "repro_flash_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _L, _L, _L, _L, _L, _L, _L, _L, _I, _F, _I, _P],
    "repro_flash_decode_paged": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _I,
                                 _F, _I, _I, _P],
}
_FA_SIGNATURES = {
    "repro_flash_attention": [_P] * 5 + [_I] * 6 + [_L] * 9
    + [_I, _I, _F, _I, _P],
    "repro_flash_attention_bwd": [_P] * 9 + [_I] * 6 + [_L] * 12
    + [_I, _I, _F, _I, _P],
}
_DMAX = 256
_FA_DMAX = 128

#: Kernel launches, counted where each wrapper launches its kernel
#: (`flash_attention_bwd` counts one for its two sweeps).
LAUNCHES = {"flash_decode": 0, "flash_decode_paged": 0,
            "flash_attention": 0, "flash_attention_bwd": 0}


def _check_qkv(q, k, v, *more) -> None:
    """q [B, Tq, H, D] against k/v [B, Tk, Hkv, D] on one card, one float
    dtype, contiguous head dims; `more` are [B, Tq, H, D] like q."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    h, hkv, d = q.shape[2], k.shape[2], q.shape[3]
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    if d > _FA_DMAX:
        raise ValueError(f"head_dim {d} > {_FA_DMAX}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t in (k, v, *more):
        if t.dtype != q.dtype:
            raise TypeError(f"every operand must be {q.dtype}, got {t.dtype}")
    for t in more:
        if t.shape != q.shape:
            raise ValueError(f"{tuple(t.shape)} != q's {tuple(q.shape)}")
    for t in (q, k, v, *more):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("every operand must be on one CUDA device")
        if t.stride(3) != 1:
            raise ValueError("the head dim must be contiguous")


def _strides(*ts):
    """(batch, time, head) strides of each [B, T, H, D] operand."""
    return [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    return_lse: bool = False):
    """Softmax attention of q [B, Tq, H, D] over k/v [B, Tk, Hkv, D]:
    query row i sees keys j <= i under `causal` and j > i - window with a
    window; q is scaled by head_dim ** -0.5. Returns o [B, Tq, H, D] in
    q's dtype, and with return_lse also the logsumexp [B, H, Tq] float32
    (1e30 on a row that sees no key, whose o is 0)."""
    _check_qkv(q, k, v)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention", _FA_SIGNATURES)
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, h, hkv, d, tq, tk, *_strides(q, k, v),
        int(causal), int(window or 0), d ** -0.5,
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    LAUNCHES["flash_attention"] += 1
    _build.check(err, "flash_attention")
    return (o, lse) if return_lse else o


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: int | None = None):
    """(dq, dk, dv) of `flash_attention` from its output o, its logsumexp
    lse [B, H, Tq] and the output's cotangent do, in the input dtype; dk
    and dv are summed over each KV head's group of query heads.
    delta = rowsum(do * o) is taken here in PyTorch, as the JAX package
    takes it in XLA."""
    _check_qkv(q, k, v, o, do)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if tuple(lse.shape) != (b, h, tq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous ({b}, {h}, {tq}) float32 "
                         f"tensor on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    delta = (do.float() * o.float()).sum(-1).contiguous()   # [B, Tq, H]
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, hkv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _build.load("flash_attention", _FA_SIGNATURES)
    err = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, h, hkv, d, tq, tk, *_strides(q, k, v, do),
        int(causal), int(window or 0), d ** -0.5,
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    LAUNCHES["flash_attention_bwd"] += 1
    _build.check(err, "flash_attention_bwd")
    return dq, dk, dv


def _check_q(q: torch.Tensor, hkv: int, d: int) -> None:
    b, tq, h, dq = q.shape
    if tq != 1:
        raise ValueError(f"decode attention is q_len=1 only: {tuple(q.shape)}")
    if dq != d:
        raise ValueError(f"q head_dim {dq} != the cache's {d}")
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    if d > _DMAX:
        raise ValueError(f"head_dim {d} > {_DMAX}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")


def _pos_vector(pos, b: int, device) -> torch.Tensor:
    """pos as an int32 (B,) tensor on the card: a (B,) tensor, or an int
    broadcast to every slot."""
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        if pos.shape[0] != b or pos.device != device:
            raise ValueError(f"pos {tuple(pos.shape)} on {pos.device} for "
                             f"{b} slots on {device}")
        return pos.to(torch.int32).contiguous()
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 pos, window: int | None = None) -> torch.Tensor:
    """Each slot's query attends its cache prefix [pos - window + 1, pos]
    (the whole prefix without a window). pos: an int, broadcast to every
    slot, or a (B,) int tensor on the card; pos < 0 gives a zero row.
    q is scaled by head_dim ** -0.5 before the dot."""
    b, _, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    _check_q(q, hkv, k.shape[3])
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("q, k and v must be on one CUDA device")
        if t.stride(3) != 1:
            raise ValueError("the head dim must be contiguous")
    pos = _pos_vector(pos, b, q.device)
    o = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_decode", _SIGNATURES)
    err = lib.repro_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        o.data_ptr(), b, h, hkv, d, tk,
        q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), int(window or 0), d ** -0.5,
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    LAUNCHES["flash_decode"] += 1
    _build.check(err, "flash_decode")
    return o


def flash_decode_paged(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                       table: torch.Tensor, *, pos, window: int | None = None,
                       ks: torch.Tensor | None = None,
                       vs: torch.Tensor | None = None) -> torch.Tensor:
    """flash_decode against a page pool: logical key t of slot b lives in
    pool page table[b, t // page_size], row t % page_size. kp/vp
    [P, page_size, Hkv, D] in q's dtype, or int8 with ks/vs
    [P, Hkv, page_size] float32 scales (dequantized in f32 before the
    dot). table: (B, pp) int32 on the card. pos as in `flash_decode`."""
    b, _, h, d = q.shape
    if kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError(f"kp {tuple(kp.shape)}, vp {tuple(vp.shape)}")
    _, ps, hkv, _ = kp.shape
    _check_q(q, hkv, kp.shape[3])
    int8_pool = ks is not None
    if (vs is not None) != int8_pool:
        raise ValueError("ks and vs go together")
    pool_dtype = torch.int8 if int8_pool else q.dtype
    if kp.dtype != pool_dtype or vp.dtype != pool_dtype:
        raise TypeError(f"a {q.dtype} query takes a {pool_dtype} pool"
                        f"{' with scales' if int8_pool else ''}, got "
                        f"{kp.dtype}/{vp.dtype}")
    if kp.stride() != vp.stride() or kp.stride(3) != 1:
        raise ValueError(f"kp and vp must share strides with a contiguous "
                         f"head dim, got {kp.stride()} and {vp.stride()}")
    if table.dim() != 2 or table.shape[0] != b \
            or table.dtype != torch.int32 or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous ({b}, pp) int32 "
                         f"tensor, got {tuple(table.shape)} {table.dtype}")
    operands = [q, kp, vp, table]
    c_page = c_head = 0
    if int8_pool:
        want = (kp.shape[0], hkv, ps)
        for s in (ks, vs):
            if tuple(s.shape) != want or s.dtype != torch.float32 \
                    or s.stride(2) != 1 or s.stride() != ks.stride():
                raise ValueError(f"scales must be {want} float32 with a "
                                 f"contiguous last dim, got "
                                 f"{tuple(s.shape)} {s.dtype} {s.stride()}")
        c_page, c_head = ks.stride(0), ks.stride(1)
        operands += [ks, vs]
    for t in operands:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("every operand must be on one CUDA device")
    if q.stride(3) != 1:
        raise ValueError("q's head dim must be contiguous")
    pos = _pos_vector(pos, b, q.device)
    o = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_decode", _SIGNATURES)
    err = lib.repro_flash_decode_paged(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        ks.data_ptr() if int8_pool else None,
        vs.data_ptr() if int8_pool else None, table.data_ptr(),
        pos.data_ptr(), o.data_ptr(), b, h, hkv, d, table.shape[1], ps,
        q.stride(0), q.stride(2), kp.stride(0), kp.stride(1), kp.stride(2),
        c_page, c_head, int(window or 0), d ** -0.5,
        int(q.dtype == torch.bfloat16), int(int8_pool),
        _build.stream_ptr(q.device))
    LAUNCHES["flash_decode_paged"] += 1
    _build.check(err, "flash_decode_paged")
    return o
