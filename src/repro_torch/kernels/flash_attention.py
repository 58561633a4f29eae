"""Wrappers of the decode-attention CUDA kernel (`csrc/flash_decode.cu`).

`flash_decode` and `flash_decode_paged` replace the Pallas kernels of the
same names in the JAX package. They keep the model's layouts: q
[B, 1, H, D] against the dense cache [B, Tk, Hkv, D], or against a page
pool [P, page_size, Hkv, D] through a page table [B, pp] (-1 unmapped),
all read in place through their strides. Each takes tensors on the card
and launches its kernel, or raises; the CPU paths are the plain versions
in `kernels.ref`, chosen by `kernels.ops`.
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
_DMAX = 256

#: Kernel launches, counted where the wrapper launches its kernel.
LAUNCHES = {"flash_decode": 0, "flash_decode_paged": 0}


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
