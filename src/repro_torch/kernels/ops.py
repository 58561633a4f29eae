"""Dispatchers over the port's kernels.

Each op validates its operands, then runs the CUDA kernel for tensors on
the card and the kernel's plain PyTorch version (`kernels.ref`) for
tensors on the CPU. The device of the tensor decides, and nothing else:
there is no fallback from a failing kernel to its plain version.

    op                  kernel (CUDA tensors)                plain version (CPU)
    matmul              matmul.matmul_tiled                  ref.fused_matmul_ref
    matmul_q            matmul.matmul_q_tiled                ref.matmul_q_ref
    gated_matmul        matmul.gated_matmul_tiled            ref.gated_matmul_ref
    flash_decode        flash_attention.flash_decode         ref.attention_fwd_ref
    flash_decode_paged  flash_attention.flash_decode_paged   ref.flash_decode_paged_ref
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import EPILOGUES


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _check_epilogue(epilogue: str) -> None:
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; registered "
                         f"epilogues: {EPILOGUES}")


def _epilogue_operand(epilogue, bias, residual, m, n):
    """Validate the flush-phase operand: None, the (n,) bias, or the
    (m, n) residual. It keeps its own dtype; the kernel casts it to the
    f32 accumulator."""
    if epilogue == "none":
        if bias is not None or residual is not None:
            raise ValueError("bias/residual operands need an epilogue")
        return None
    if epilogue == "residual":
        if residual is None or tuple(residual.shape) != (m, n):
            raise ValueError(
                f"epilogue='residual' needs residual of shape {(m, n)}, "
                f"got {None if residual is None else tuple(residual.shape)}")
        return residual
    if bias is None:
        raise ValueError(f"epilogue={epilogue!r} needs bias=")
    e = bias.reshape(-1)
    if e.shape[0] != n:
        raise ValueError(f"bias shape {tuple(bias.shape)} incompatible with n={n}")
    return e


def matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None,
           epilogue: str = "none", bias: torch.Tensor | None = None,
           residual: torch.Tensor | None = None) -> torch.Tensor:
    """2D GEMM ``epilogue(a @ b)``, the epilogue applied on the f32
    accumulator and the result rounded once to out_dtype (default: a's)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    _check_epilogue(epilogue)
    m, n = a.shape[0], b.shape[1]
    e = _epilogue_operand(epilogue, bias, residual, m, n)
    out_dtype = out_dtype or a.dtype
    if _on_card(a):
        return _mm.matmul_tiled(a, b, out_dtype=out_dtype, epilogue=epilogue,
                                epilogue_operand=e)
    return _ref.fused_matmul_ref(a, b, out_dtype, epilogue, bias=e, residual=e)


def _check_quant_operands(wq, scale, k, n):
    """Validate the (Wq, scale) pair; returns scale as (1, n)."""
    if wq.dtype != torch.int8:
        raise ValueError(f"matmul_q weights must be int8 "
                         f"(core.precision.quantize_int8), got {wq.dtype}")
    if tuple(wq.shape) != (k, n):
        raise ValueError(f"quantized weight shape {tuple(wq.shape)} "
                         f"incompatible with ({k}, {n})")
    s = scale.reshape(1, -1) if scale.dim() == 1 else scale
    if tuple(s.shape) != (1, n):
        raise ValueError(f"per-channel scale shape {tuple(scale.shape)} "
                         f"incompatible with n={n}; expected ({n},) or "
                         f"(1, {n})")
    if not s.is_floating_point():
        raise ValueError(f"scale must be floating, got {s.dtype}")
    return s


def matmul_q(a: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *,
             out_dtype=None, epilogue: str = "none",
             bias: torch.Tensor | None = None,
             residual: torch.Tensor | None = None) -> torch.Tensor:
    """2D GEMM against int8 per-channel weights,
    ``epilogue((a @ wq) * scale)``: the scale and the epilogue applied on
    the f32 accumulator and the result rounded once to out_dtype
    (default: a's)."""
    if a.dim() != 2 or wq.dim() != 2 or a.shape[1] != wq.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(wq.shape)}")
    _check_epilogue(epilogue)
    m, k = a.shape
    n = wq.shape[1]
    s = _check_quant_operands(wq, scale, k, n)
    e = _epilogue_operand(epilogue, bias, residual, m, n)
    out_dtype = out_dtype or a.dtype
    if _on_card(a):
        return _mm.matmul_q_tiled(a, wq, s.float(), out_dtype=out_dtype,
                                  epilogue=epilogue, epilogue_operand=e)
    return _ref.matmul_q_ref(a, wq, s, out_dtype, epilogue, bias=e,
                             residual=e)


def gated_matmul(a: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor) -> torch.Tensor:
    """silu(a @ w_gate) * (a @ w_up), the SwiGLU hidden phase, in a's
    dtype."""
    if a.dim() != 2 or w_gate.shape != w_up.shape \
            or w_gate.shape[0] != a.shape[1]:
        raise ValueError(f"shapes {tuple(a.shape)}, {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}")
    if _on_card(a):
        return _mm.gated_matmul_tiled(a, w_gate, w_up)
    return _ref.gated_matmul_ref(a, w_gate, w_up)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 pos=0, window: int | None = None) -> torch.Tensor:
    """Decode attention, q [B, 1, H, D] against the cache [B, Tk, Hkv, D]:
    each slot's query attends its prefix [0, pos] (the last `window` keys
    of it with a window). pos: an int or a (B,) vector; a slot with
    pos < 0 is idle and gets a zero row."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode is q_len=1 only: {tuple(q.shape)}")
    if _on_card(q):
        return _fa.flash_decode(q, k, v, pos=pos, window=window)
    return _ref.attention_fwd_ref(q, k, v, window=window, q_offset=pos)


def flash_decode_paged(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                       table: torch.Tensor, *, pos=0,
                       window: int | None = None,
                       ks: torch.Tensor | None = None,
                       vs: torch.Tensor | None = None) -> torch.Tensor:
    """Decode attention against a page pool (the `serving.kv_pool`
    layout): slot b's logical page j lives at pool page table[b, j], -1
    unmapped. kp/vp [P, page_size, Hkv, D]; an int8 pool comes with its
    [P, Hkv, page_size] f32 scale planes ks/vs. The pos, window and
    idle-slot contract of `flash_decode`."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"flash_decode_paged is q_len=1 only: "
                         f"{tuple(q.shape)}")
    if kp.dim() != 4 or kp.shape != vp.shape:
        raise ValueError(f"kp {tuple(kp.shape)} and vp {tuple(vp.shape)} "
                         f"must be equal [P, page_size, Hkv, D] pools")
    if (ks is None) != (vs is None):
        raise ValueError("ks and vs go together")
    if (ks is not None) != (kp.dtype == torch.int8):
        raise ValueError(f"scale planes go with an int8 pool, and only "
                         f"with one: {kp.dtype} pool, scales "
                         f"{'given' if ks is not None else 'missing'}")
    if _on_card(q):
        return _fa.flash_decode_paged(q, kp, vp, table, pos=pos,
                                      window=window, ks=ks, vs=vs)
    return _ref.flash_decode_paged_ref(q, kp, vp, table, pos=pos,
                                       window=window, ks=ks, vs=vs)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel."""
    return {**_mm.LAUNCHES, **_fa.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (_mm.LAUNCHES, _fa.LAUNCHES):
        for name in counts:
            counts[name] = 0
