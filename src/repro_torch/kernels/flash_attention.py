"""Wrapper of the decode-attention CUDA kernel (`csrc/flash_decode.cu`).

`flash_decode` replaces the Pallas kernel of the same name in the JAX
package. It keeps the model's layout: q [B, 1, H, D] against the cache
[B, Tk, Hkv, D], both read in place through their strides. It takes
tensors on the card and launches its kernel, or raises; the CPU path is
`kernels.ref.attention_fwd_ref`, chosen by `kernels.ops`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "repro_flash_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _L, _L, _L, _L, _L, _L, _L, _L, _I, _F, _I, _P],
}
_DMAX = 256

#: Kernel launches, counted where the wrapper launches its kernel.
LAUNCHES = {"flash_decode": 0}


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 pos, window: int | None = None) -> torch.Tensor:
    """Each slot's query attends its cache prefix [pos - window + 1, pos]
    (the whole prefix without a window). pos: an int, broadcast to every
    slot, or a (B,) int tensor on the card; pos < 0 gives a zero row.
    q is scaled by head_dim ** -0.5 before the dot."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    if tq != 1:
        raise ValueError(f"flash_decode is q_len=1 only: {tuple(q.shape)}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    if d > _DMAX:
        raise ValueError(f"head_dim {d} > {_DMAX}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("q, k and v must be on one CUDA device")
        if t.stride(3) != 1:
            raise ValueError("the head dim must be contiguous")
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        if pos.shape[0] != b or pos.device != q.device:
            raise ValueError(f"pos {tuple(pos.shape)} on {pos.device} for "
                             f"{b} slots on {q.device}")
        pos = pos.to(torch.int32).contiguous()
    else:
        pos = torch.full((b,), int(pos), dtype=torch.int32, device=q.device)
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
