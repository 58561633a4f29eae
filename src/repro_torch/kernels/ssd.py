"""The SSD (Mamba-2) scan: the wrapper of the intra-chunk CUDA kernel
(`csrc/ssd.cu`) and the chunked scan around it.

`ssd_intra_chunk` replaces the Pallas kernel of the same name in the JAX
package: per chunk of each head, the decay-masked blocked product y_diag
and the chunk's state, one launch for both. `ssd_chunked` is the
counterpart of the JAX package's `ssd_pallas`: the kernel for the
intra-chunk terms, then the inter-chunk recurrence over the chunks (f32
state, seeded by `init_state`) and the state -> output term in plain
PyTorch, as JAX leaves them to XLA. The kernel reads x, a, B and C in the
model's (B, L, H, .) / (B, L, G, .) layouts through their strides: no
transposed copy, and no copy of B and C for each head of a group.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "repro_ssd_intra_chunk": [_P] * 6 + [_I] * 7 + [_L] * 12 + [_I, _P],
}
_PMAX, _NMAX, _QMAX = 128, 256, 2048

#: Kernel launches, counted where the wrapper launches its kernel: one an
#: `ssd_intra_chunk` call, which computes y_diag and the states in one
#: grid.
LAUNCHES = {"ssd": 0}


def ssd_intra_chunk(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, chunk: int):
    """Per chunk of `chunk` steps of each head (head h reads group
    h // (H / G) of B and C):
        y_diag[i] = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) x_j
        state     = sum_j (B_j exp(cs_last - cs_j))^T x_j
    with cs the chunk's running sum of a, the decay masked in log space
    before the exp. x (B, L, H, P), a (B, L, H), b/c (B, L, G, N) on the
    card, L a multiple of chunk; x, b and c float32 or all three bfloat16
    (a any float, taken as float32). Returns (y_diag (B, L, H, P) f32,
    states (B, H, nc, N, P) f32), as `ref.ssd_intra_chunk_ref`."""
    bsz, l, h, p = x.shape
    g, n = b.shape[-2:]
    if l % chunk or not 0 < chunk <= _QMAX:
        raise ValueError(f"seq len {l} must be a multiple of a chunk in "
                         f"[1, {_QMAX}], got {chunk}")
    if p > _PMAX or n > _NMAX:
        raise ValueError(f"head_dim {p} > {_PMAX} or d_state {n} > {_NMAX}")
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b and c must all be float32 or all bfloat16, got "
                        f"{x.dtype}/{b.dtype}/{c.dtype}")
    a = a.float()
    for t in (x, a, b, c):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError("every operand must be on one CUDA device")
        if t.dim() == 4 and t.stride(3) != 1:
            raise ValueError("the last dim of x, b and c must be contiguous")
    nc = l // chunk
    y = torch.empty((bsz, l, h, p), dtype=torch.float32, device=x.device)
    states = torch.empty((bsz, h, nc, n, p), dtype=torch.float32,
                         device=x.device)
    lib = _build.load("ssd", _SIGNATURES)
    err = lib.repro_ssd_intra_chunk(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
        states.data_ptr(), bsz, l, h, g, p, n, chunk,
        x.stride(0), x.stride(1), x.stride(2),
        a.stride(0), a.stride(1), a.stride(2),
        b.stride(0), b.stride(1), b.stride(2),
        c.stride(0), c.stride(1), c.stride(2),
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))
    LAUNCHES["ssd"] += 1
    _build.check(err, "ssd_intra_chunk")
    return y, states


def _intra_chunk(x, a, b, c, chunk):
    """The kernel for tensors on the card, its plain version on the CPU.
    x, b and c not all of one kernel dtype go to the kernel as float32,
    which every float up to float32 casts to exactly."""
    if x.device.type == "cpu":
        return _ref.ssd_intra_chunk_ref(x, a, b, c, chunk)
    if x.dtype == torch.float64:
        raise TypeError("the CUDA SSD kernel computes in float32; float64 "
                        "runs through ref.ssd_chunked_ref on the CPU")
    if not (x.dtype == b.dtype == c.dtype == torch.bfloat16):
        x, b, c = x.float(), b.float(), c.float()
    return ssd_intra_chunk(x, a, b, c, chunk)


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None):
    """The chunked SSD scan with its intra-chunk work in the kernel: the
    JAX package's `ssd_pallas` contract. x (B, L, H, P) dt-scaled,
    a (B, L, H), b/c (B, L, G, N), init_state (B, H, P, N) or None.
    Returns (y in x's dtype, final_state (B, H, P, N) f32)."""
    bsz, l, h, p = x.shape
    g, n = b.shape[-2:]
    rep = h // g
    nc = l // chunk
    y_diag, states = _intra_chunk(x, a, b, c, chunk)

    # inter-chunk recurrence (a rank-N state, carried in f32); the
    # kernel's state layout is (N, P), the contract's (P, N)
    a_cum = a.float().reshape(bsz, nc, chunk, h).cumsum(2)     # (B,nc,Q,H)
    chunk_decay = torch.exp(a_cum[:, :, -1])                   # (B,nc,H)
    s = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float().transpose(-1, -2))
    prev = []
    for ci in range(nc):
        prev.append(s)                                         # state *before*
        s = s * chunk_decay[:, ci, :, None, None] + states[:, :, ci]
    prev_states = torch.stack(prev, dim=2)                     # (B,H,nc,N,P)

    # state -> output: C of group g against the states of its heads
    cg = c.float().reshape(bsz, nc, chunk, g, n)
    y_off = torch.einsum("bcqgn,bgrcnp->bcqgrp", cg,
                         prev_states.reshape(bsz, g, rep, nc, n, p))
    y_off = y_off.reshape(bsz, nc, chunk, h, p) * torch.exp(a_cum)[..., None]
    y = y_diag + y_off.reshape(bsz, l, h, p)
    return y.to(x.dtype), s.transpose(-1, -2)
