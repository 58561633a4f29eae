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
    flash_attention_fwd flash_attention.flash_attention      ref.flash_attention_fwd_ref
    flash_attention_bwd flash_attention.flash_attention_bwd  ref.flash_attention_bwd_ref
    ssd                 ssd.ssd_chunked (ssd_intra_chunk)    ref.ssd_chunked_ref
    matmul_naive        matmul_naive.matmul_naive            ref.matmul_ref
    add / sub           elementwise.binary_op                ref.add_ref / ref.sub_ref
    axpy                elementwise.axpy                     ref.saxpy_ref

`matmul_naive`, `add`, `sub` and `axpy` are the paper's experiment
(Table 2, Figs 8-9), each an entry point of its own: the naive GEMM is
not a backend of `matmul`, which is the tiled kernel and keeps refusing
float64 on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import elementwise as _ew
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import matmul_naive as _mmn
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssd as _ssd
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


def _check_bthd(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} must be [B, Tq, H, D] against "
                         f"k/v [B, Tk, Hkv, D] with Hkv dividing H, got k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None):
    """Attention of q [B, Tq, H, D] over k/v [B, Tk, Hkv, D] with the
    residual its backward needs: (o [B, Tq, H, D] in q's dtype,
    lse [B, H, Tq] float32)."""
    _check_bthd(q, k, v)
    if _on_card(q):
        return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    return _ref.flash_attention_fwd_ref(q, k, v, causal=causal, window=window)


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int | None = None):
    """(dq, dk, dv) of `flash_attention_fwd` from its (o, lse) and the
    cotangent do [B, Tq, H, D], in the input dtypes; dk/dv [B, Tk, Hkv,
    D], summed over each KV head's group of query heads."""
    _check_bthd(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"be q's {tuple(q.shape)}")
    if _on_card(q):
        return _fa.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                       window=window)
    return _ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                        window=window)


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        chunk: int, init_state: torch.Tensor | None = None):
    """Chunked SSD scan (the Mamba-2 dual form) of x (B, L, H, P)
    dt-scaled inputs, a (B, L, H) log-decays and b/c (B, L, G, N), L a
    multiple of chunk, seeded by init_state (B, H, P, N). Returns (y
    (B, L, H, P) in x's dtype, final_state (B, H, P, N) float32); the
    inter-chunk state is carried in float32 whatever the inputs. On the
    card one call launches the intra-chunk kernel once."""
    if x.dim() != 4 or a.dim() != 3 or b.dim() != 4 or c.dim() != 4:
        raise ValueError(f"ssd expects x(B,L,H,P) a(B,L,H) b/c(B,L,G,N); "
                         f"got {tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    bsz, l, h, p = x.shape
    g, n = b.shape[-2:]
    if tuple(a.shape) != (bsz, l, h):
        raise ValueError(f"a shape {tuple(a.shape)} incompatible with x "
                         f"{tuple(x.shape)}")
    if tuple(b.shape) != (bsz, l, g, n) or c.shape != b.shape:
        raise ValueError(f"b/c shapes {tuple(b.shape)}/{tuple(c.shape)} "
                         f"must match")
    if h % g:
        raise ValueError(f"heads {h} not divisible by groups {g}")
    if chunk <= 0 or l % chunk:
        raise ValueError(f"seq len {l} not divisible by chunk {chunk}")
    if init_state is not None and tuple(init_state.shape) != (bsz, h, p, n):
        raise ValueError(f"init_state shape {tuple(init_state.shape)} != "
                         f"{(bsz, h, p, n)}")
    if _on_card(x):
        return _ssd.ssd_chunked(x, a, b, c, chunk, init_state)
    return _ref.ssd_chunked_ref(x, a, b, c, chunk, init_state)


def matmul_naive(a: torch.Tensor, b: torch.Tensor, *,
                 out_dtype=None) -> torch.Tensor:
    """2D GEMM ``a @ b`` by the paper's Listing 3 (one thread an output
    element, no shared memory): the sum in f32 (f64 for float64 inputs)
    rounded once to out_dtype (default: a's)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    out_dtype = out_dtype or a.dtype
    if _on_card(a):
        return _mmn.matmul_naive(a, b, out_dtype=out_dtype)
    return _ref.matmul_ref(a, b, out_dtype)


def _binary(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.shape != b.shape:
        raise ValueError(f"shapes {tuple(a.shape)} and {tuple(b.shape)} "
                         f"differ")
    if a.dtype != b.dtype:
        raise TypeError(f"dtypes {a.dtype} and {b.dtype} differ")
    if not _on_card(a):
        return _ref.binary_ref(a, b, op)
    if a.is_complex():
        # complex add and sub act on the (re, im) pairs: the same
        # function, exactly, through the real kernel
        return torch.view_as_complex(_ew.binary_op(
            torch.view_as_real(a), torch.view_as_real(b), op))
    return _ew.binary_op(a, b, op)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b for operands of one shape and dtype, in that dtype."""
    return _binary("add", a, b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b for operands of one shape and dtype, in that dtype."""
    return _binary("sub", a, b)


def axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """alpha * x + y in x's dtype, alpha (a number, or a one-element tensor
    on x's device) cast to x's dtype first, the product rounded before the
    sum."""
    if x.shape != y.shape:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(y.shape)} "
                         f"differ")
    if x.dtype != y.dtype:
        raise TypeError(f"dtypes {x.dtype} and {y.dtype} differ")
    if _on_card(x):
        return _ew.axpy(alpha, x, y)
    return _ref.saxpy_ref(alpha, x, y)


_COUNTERS = (_mm.LAUNCHES, _fa.LAUNCHES, _ssd.LAUNCHES, _mmn.LAUNCHES,
             _ew.LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches so far, by kernel."""
    return {name: n for counts in _COUNTERS for name, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0
