"""The port's CUDA kernels against their plain PyTorch versions, on the
card: ragged edges, both A and B layouts, the bf16 GEMM's tensor-core
tile plans and the f32 GEMM's two tiles (every row tile, unaligned
operands, K = 0, one row's bits at every M), int8 weights and the dual GEMM (their plan boundaries, offset views,
K = 0, one row's bits at every M), strided cache
views, page pools (bf16, f32 and int8 pages, shuffled, -1 past each
prefix), GQA groups, idle and windowed slots, a decode row's bits at any
batch, cache depth and page order, the training attention's forward and
backward (ragged T, windows, GQA groups up to 8, rows that see no key, the
bf16 kernels' padded head dims, the forward's (o, lse) through the
backward), the SSD
intra-chunk kernel (ragged chunks, groups read through strides, bf16
inputs, a carried state, strong decays), the paper's naive GEMM and
elementwise kernels (add, sub, mul and axpy bit for bit), whole decode
steps, dense, paged and Mamba-2, a whole train step, and the serving
engine's steps as CUDA graphs (a replay against the eager step bit for
bit, launch counts, no wrapper called, a capture that syncs refused).

Marked `cuda`; each test skips where there is no CUDA device. On the
card: `PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`.
Tolerance: f32 atol = rtol = 1e-4 (sums in another order); bf16 outputs
may differ by one rounding of the f32 result (rtol 2^-7) plus atol 1e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import precision
from repro_torch.core.tree import leaves, tree_map
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW
from repro_torch.serving import ServingEngine
from repro_torch.training import train_loop as TL

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=1e-3, rtol=2 ** -7)}
EPILOGUES = ("none", "bias", "bias_gelu", "bias_silu", "residual")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(*shape, dtype, dev, seed, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _close(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("mkn", [(5, 37, 19), (1, 64, 130), (70, 100, 65),
                                 (129, 33, 257)])
@pytest.mark.parametrize("b_nk", [False, True])
def test_matmul_kernel_matches_plain(dev, dtype, epilogue, mkn, b_nk):
    m, k, n = mkn
    a = _randn(m, k, dtype=dtype, dev=dev, seed=0)
    b = _randn(n, k, dtype=dtype, dev=dev, seed=1, scale=k ** -0.5).t() \
        if b_nk else _randn(k, n, dtype=dtype, dev=dev, seed=1, scale=k ** -0.5)
    kw = {}
    if epilogue == "residual":
        kw["residual"] = _randn(m, n, dtype=dtype, dev=dev, seed=2)
    elif epilogue != "none":
        kw["bias"] = _randn(n, dtype=torch.float32, dev=dev, seed=3)
    for out_dtype in (dtype, torch.float32):
        got = ops.matmul(a, b, out_dtype=out_dtype, epilogue=epilogue, **kw)
        want = ref.fused_matmul_ref(a, b, out_dtype, epilogue,
                                    kw.get("bias"), kw.get("residual"))
        _close(got, want, out_dtype if out_dtype == dtype else torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", ["none", "residual"])
@pytest.mark.parametrize("mkn", [(5, 37, 19), (64, 130, 70), (1024, 512, 96)])
@pytest.mark.parametrize("b_nk", [False, True])
def test_matmul_transposed_a_matches_plain(dev, dtype, epilogue, mkn, b_nk):
    """A as the transpose view of a [K, M] tensor: the weight gradient
    aᵀ @ g of the GEMM's backward."""
    m, k, n = mkn
    a = _randn(k, m, dtype=dtype, dev=dev, seed=0).t()
    b = _randn(n, k, dtype=dtype, dev=dev, seed=1, scale=k ** -0.5).t() \
        if b_nk else _randn(k, n, dtype=dtype, dev=dev, seed=1, scale=k ** -0.5)
    r = _randn(m, n, dtype=dtype, dev=dev, seed=2) \
        if epilogue == "residual" else None
    got = ops.matmul(a, b, epilogue=epilogue, residual=r)
    want = ref.fused_matmul_ref(a, b, dtype, epilogue, residual=r)
    _close(got, want, dtype)


LAYOUTS = [(False, False), (False, True), (True, False), (True, True)]


def _gemm_operands(dev, m, k, n, a_km, b_nk, seed=0, dtype=torch.bfloat16,
                   off=0, pad=0):
    """A [m, k] and B [k, n] as row-major tensors or as transpose views (A
    of a [k, m] tensor, B of an [n, k] one), `off` elements into rows `pad`
    longer than they need (off 1: no row is 16-byte aligned)."""
    a = _randn(k, m + off + pad, dtype=dtype, dev=dev,
               seed=seed)[:, off:off + m].t() if a_km \
        else _randn(m, k + off + pad, dtype=dtype, dev=dev,
                    seed=seed)[:, off:off + k]
    b = _randn(n, k + off + pad, dtype=dtype, dev=dev, seed=seed + 1,
               scale=k ** -0.5)[:, off:off + k].t() if b_nk \
        else _randn(k, n + off + pad, dtype=dtype, dev=dev, seed=seed + 1,
                    scale=k ** -0.5)[:, off:off + n]
    return a, b


def _epilogue_kw(dev, epilogue, m, n, dtype=torch.bfloat16):
    if epilogue == "residual":
        return {"residual": _randn(m, n, dtype=dtype, dev=dev, seed=2)}
    if epilogue != "none":
        return {"bias": _randn(n, dtype=torch.float32, dev=dev, seed=3)}
    return {}


def _check_matmul(a, b, epilogue, kw):
    for out_dtype in (torch.bfloat16, torch.float32):
        got = ops.matmul(a, b, out_dtype=out_dtype, epilogue=epilogue, **kw)
        want = ref.fused_matmul_ref(a, b, out_dtype, epilogue,
                                    kw.get("bias"), kw.get("residual"))
        _close(got, want, out_dtype)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("m", [1, 4, 15, 16, 17, 130, 2048])
def test_bf16_matmul_on_tensor_cores_matches_plain(dev, m, layout, epilogue):
    """Every row tile of the tensor-core GEMM, each layout, odd K and N."""
    k, n = 301, 259
    a, b = _gemm_operands(dev, m, k, n, *layout)
    _check_matmul(a, b, epilogue, _epilogue_kw(dev, epilogue, m, n))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("m", [1, 4, 16, 130])
def test_bf16_matmul_wide_n_matches_plain(dev, m, layout):
    """The 32-column decode tile of the logits' width, ragged N."""
    a, b = _gemm_operands(dev, m, 96, 32771, *layout)
    _check_matmul(a, b, "none", {})


@pytest.mark.parametrize("epilogue", ["none", "residual"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("m", [17, 2047])
def test_bf16_matmul_wide_tile_ragged_edges(dev, m, layout, epilogue):
    """The wide tile (TMA and wgmma) with ragged M, K and N and leading
    dims padded to 16 bytes: the zero fill past the edges."""
    k, n = 301, 1031
    a_km, b_nk = layout
    a = _randn(k, -(-m // 8) * 8 + 8, dtype=torch.bfloat16, dev=dev,
               seed=0)[:, :m].t() \
        if a_km else _randn(m, k + 3, dtype=torch.bfloat16, dev=dev, seed=0)[:, :k]
    b = _randn(n, k + 3, dtype=torch.bfloat16, dev=dev, seed=1,
               scale=k ** -0.5)[:, :k].t() if b_nk \
        else _randn(k, n + 9, dtype=torch.bfloat16, dev=dev, seed=1,
                    scale=k ** -0.5)[:, :n]
    _check_matmul(a, b, epilogue, _epilogue_kw(dev, epilogue, m, n))


@pytest.mark.parametrize("epilogue", ["bias", "residual"])
@pytest.mark.parametrize("m", [4, 2048])
def test_bf16_matmul_of_empty_k_is_the_epilogue(dev, m, epilogue):
    """K = 0: every tile plan flushes the epilogue of a zero sum."""
    a = torch.empty((m, 0), dtype=torch.bfloat16, device=dev)
    b = torch.empty((0, 1024), dtype=torch.bfloat16, device=dev)
    _check_matmul(a, b, epilogue, _epilogue_kw(dev, epilogue, m, 1024))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mn", [(4, 45), (130, 45), (2048, 1030)])
def test_bf16_matmul_reads_unaligned_operands(dev, mn, layout):
    """Leading dims of odd length and bases one element into a buffer:
    the element-by-element loads (the wide plan's on the narrow tile)."""
    (m, n), k = mn, 77
    a_km, b_nk = layout
    a = _randn(k, m + 3, dtype=torch.bfloat16, dev=dev, seed=0)[:, 1:m + 1].t() \
        if a_km else _randn(m, k + 3, dtype=torch.bfloat16, dev=dev, seed=0)[:, 1:k + 1]
    b = _randn(n, k + 3, dtype=torch.bfloat16, dev=dev, seed=1,
               scale=k ** -0.5)[:, 1:k + 1].t() if b_nk \
        else _randn(k, n + 3, dtype=torch.bfloat16, dev=dev, seed=1,
                    scale=k ** -0.5)[:, 1:n + 1]
    _check_matmul(a, b, "residual", _epilogue_kw(dev, "residual", m, n))


@pytest.mark.parametrize("kn", [(1024, 1024), (3072, 1024), (1024, 40960),
                                (1024, 1536)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_bf16_matmul_is_batch_invariant(dev, layout, kn):
    """A row of C has the same bits at M = 4, 20, 136 and 2048 as alone at
    M = 1 (each tile plan sums k in one order), in every layout, at the
    main path's (K, N), at the logits' decode tile and at the 192-wide
    tile (N = 1536 at M = 2048). M = 20 is a verify step's (4 slots x 5
    tokens), past the decode tile's 16 rows."""
    k, n = kn
    a_km, b_nk = layout
    a, b = _gemm_operands(dev, 2048, k, n, a_km, b_nk)
    rows = [0, 3, 135, 2047]
    for out_dtype in (torch.bfloat16, torch.float32):
        alone = {r: ops.matmul(a[r:r + 1], b, out_dtype=out_dtype)
                 for r in rows}
        for m in (4, 20, 136, 2048):
            c = ops.matmul(a[:m], b, out_dtype=out_dtype)
            for r in rows:
                if r < m:
                    assert torch.equal(c[r:r + 1], alone[r]), (m, r, out_dtype)


# (M, K, N, the f32 tile's rows): ragged M, N and K (K not a multiple of
# either tile's k-step, and under one k-step) on the 64x64 and the wide
# tile
F32_SHAPES = [(5, 37, 19, 64), (70, 1001, 65, 64), (1000, 1001, 1100, 128),
              (130, 9, 6000, 128), (257, 300, 3001, 128)]


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", F32_SHAPES)
def test_f32_matmul_tiles_match_plain(dev, shape, layout, epilogue):
    """Both f32 tiles (`f32_tile_plan`) in every layout, with every
    epilogue, to f32 and bf16."""
    from repro_torch.kernels import matmul as tmm
    m, k, n, bm = shape
    assert tmm.f32_tile_plan(m, k, n).bm == bm
    a, b = _gemm_operands(dev, m, k, n, *layout, dtype=torch.float32)
    _check_matmul(a, b, epilogue,
                  _epilogue_kw(dev, epilogue, m, n, torch.float32))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mn", [(4, 45), (1000, 1100)])
def test_f32_matmul_reads_unaligned_operands(dev, mn, layout):
    """Rows one element into a buffer and of odd length: each operand
    element by element (4-byte cp.async or scalar loads), both tiles."""
    (m, n), k = mn, 77
    a, b = _gemm_operands(dev, m, k, n, *layout, dtype=torch.float32, off=1,
                          pad=2)
    _check_matmul(a, b, "residual",
                  _epilogue_kw(dev, "residual", m, n, torch.float32))


@pytest.mark.parametrize("epilogue", ["bias", "residual"])
@pytest.mark.parametrize("m", [4, 1024])
def test_f32_matmul_of_empty_k_is_the_epilogue(dev, m, epilogue):
    """K = 0: both f32 tiles flush the epilogue of a zero sum."""
    n = 1100
    a = torch.empty((m, 0), dtype=torch.float32, device=dev)
    b = torch.empty((0, n), dtype=torch.float32, device=dev)
    _check_matmul(a, b, epilogue,
                  _epilogue_kw(dev, epilogue, m, n, torch.float32))


@pytest.mark.parametrize("k", [1000, 4096])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_f32_matmul_is_batch_invariant(dev, layout, k):
    """A row of the f32 GEMM has the same bits at M = 4, 136, 1024 and
    4096 as alone at M = 1, in every layout, at a ragged K and at the
    paper's 4096: the 64x64 tile (M <= 1024 here) and the wide one (M =
    4096) sum each output in one order."""
    n = 1024
    a, b = _gemm_operands(dev, 4096, k, n, *layout, dtype=torch.float32)
    rows = [0, 3, 135, 4095]
    for out_dtype in (torch.float32, torch.bfloat16):
        alone = {r: ops.matmul(a[r:r + 1], b, out_dtype=out_dtype)
                 for r in rows}
        for m in (4, 136, 1024, 4096):
            c = ops.matmul(a[:m], b, out_dtype=out_dtype)
            for r in rows:
                if r < m:
                    assert torch.equal(c[r:r + 1], alone[r]), (m, r, out_dtype)


# (B, T, H, Hkv, D) and (Tq, Tk) where they differ: ragged T, GQA groups
# of 1, 2 and 4, the training shape's head_dim
ATTN_SHAPES = [(2, 37, 4, 2, 16), (1, 130, 8, 8, 64), (2, 200, 4, 1, 128),
               (1, 512, 4, 2, 128)]


def _attn_inputs(dev, dtype, shape, tk=None):
    b, t, h, hkv, d = shape
    q = _randn(b, t, h, d, dtype=dtype, dev=dev, seed=0)
    k = _randn(b, tk or t, hkv, d, dtype=dtype, dev=dev, seed=1)
    v = _randn(b, tk or t, hkv, d, dtype=dtype, dev=dev, seed=2)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("window", [None, 7, 128])
def test_flash_attention_kernel_matches_plain(dev, dtype, shape, window):
    q, k, v = _attn_inputs(dev, dtype, shape)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True, window=window)
    want_o, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=True,
                                                   window=window)
    _close(o, want_o, dtype)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


def test_flash_attention_rows_that_see_no_key(dev):
    """Not causal, a window of 4 and Tk < Tq: rows from 23 on see no key
    and get o = 0 and the 1e30 sentinel; the backward gives them nothing."""
    q, k, v = _attn_inputs(dev, torch.float32, (2, 40, 4, 2, 16), tk=20)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=False, window=4)
    want_o, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=False,
                                                   window=4)
    assert torch.equal(lse[:, :, 23:], torch.full_like(lse[:, :, 23:], 1e30))
    assert torch.equal(o[:, 23:], torch.zeros_like(o[:, 23:]))
    _close(o, want_o, torch.float32)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
    do = _randn(*q.shape, dtype=torch.float32, dev=dev, seed=3)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=False, window=4)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=False,
                                       window=4)
    for x, y in zip(got, want):
        _close(x, y, torch.float32)


def test_bf16_flash_attention_rows_that_see_no_key(dev):
    """The tensor-core forward: rows that see no key get o = 0 and the
    1e30 sentinel."""
    q, k, v = _attn_inputs(dev, torch.bfloat16, (2, 40, 4, 2, 16), tk=20)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=False, window=4)
    want_o, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=False,
                                                   window=4)
    assert torch.equal(lse[:, :, 23:], torch.full_like(lse[:, :, 23:], 1e30))
    assert torch.equal(o[:, 23:], torch.zeros_like(o[:, 23:]))
    _close(o, want_o, torch.bfloat16)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


@pytest.mark.parametrize("shape", [(2, 45, 4, 2, 36), (1, 70, 2, 1, 80)])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_flash_attention_pads_head_dim(dev, shape, causal):
    """A head_dim that is no multiple of 16 (36: no multiple of 8 either,
    so no 16-byte load) and Tk != Tq."""
    q, k, v = _attn_inputs(dev, torch.bfloat16, shape, tk=shape[1] + 19)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    want_o, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal)
    _close(o, want_o, torch.bfloat16)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("window", [None, 128])
def test_bf16_flash_attention_feeds_the_backward(dev, shape, window):
    """The tensor-core forward's (o, lse) through the FMA backward give the
    plain forward-and-backward's gradients."""
    q, k, v = _attn_inputs(dev, torch.bfloat16, shape)
    do = _randn(*q.shape, dtype=torch.bfloat16, dev=dev, seed=3)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True, window=window)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                  window=window)
    o_p, lse_p = ref.flash_attention_fwd_ref(q, k, v, causal=True,
                                             window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, o_p, do, lse_p, causal=True,
                                       window=window)
    for x, y in zip(got, want):
        _close(x, y, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_SHAPES + [(1, 500, 16, 2, 128)])
@pytest.mark.parametrize("window", [None, 7, 128])
def test_flash_attention_bwd_kernel_matches_plain(dev, dtype, shape, window):
    """GQA groups 1, 2, 4 and 8, ragged T (37, 130, 200, 500)."""
    q, k, v = _attn_inputs(dev, dtype, shape)
    o, lse = ref.flash_attention_fwd_ref(q, k, v, causal=True, window=window)
    do = _randn(*q.shape, dtype=dtype, dev=dev, seed=3)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                  window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=True,
                                       window=window)
    for x, y in zip(got, want):
        _close(x, y, dtype)


@pytest.mark.parametrize("shape", [(2, 45, 4, 2, 36), (1, 70, 2, 1, 80)])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_flash_attention_bwd_pads_head_dim(dev, shape, causal):
    """The tensor-core backward on a head_dim that is no multiple of 16
    (36: no multiple of 8 either, so no 16-byte load) and Tk != Tq."""
    q, k, v = _attn_inputs(dev, torch.bfloat16, shape, tk=shape[1] + 19)
    o, lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal)
    do = _randn(*q.shape, dtype=torch.bfloat16, dev=dev, seed=3)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal)
    for x, y in zip(got, want):
        _close(x, y, torch.bfloat16)


def test_bf16_flash_attention_bwd_rows_that_see_no_key(dev):
    """Not causal, a window of 4 and Tk < Tq: rows from 23 on see no key
    (lse 1e30), and the tensor-core backward gives them dq = 0 and adds
    nothing of theirs to dk and dv."""
    q, k, v = _attn_inputs(dev, torch.bfloat16, (2, 40, 4, 2, 16), tk=20)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=False, window=4)
    do = _randn(*q.shape, dtype=torch.bfloat16, dev=dev, seed=3)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=False, window=4)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=False,
                                       window=4)
    assert torch.equal(got[0][:, 23:], torch.zeros_like(got[0][:, 23:]))
    for x, y in zip(got, want):
        _close(x, y, torch.bfloat16)
    # the rows that see no key change nothing of dk and dv
    do2 = do.clone()
    do2[:, 23:] = _randn(2, 17, 4, 16, dtype=torch.bfloat16, dev=dev, seed=4)
    again = ops.flash_attention_bwd(q, k, v, o, do2, lse, causal=False,
                                    window=4)
    assert torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])


def test_flash_attention_bwd_is_deterministic(dev):
    q, k, v = _attn_inputs(dev, torch.bfloat16, (2, 200, 4, 1, 128))
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True)
    do = _randn(*q.shape, dtype=torch.bfloat16, dev=dev, seed=3)
    first = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    for x, y in zip(first, again):
        assert torch.equal(x, y)


def _offset(x: torch.Tensor) -> torch.Tensor:
    """x's values through a view whose base is one element into a buffer
    and whose leading dim is 3 elements longer: an operand no 16-byte
    load can take."""
    big = torch.zeros((x.shape[0], x.shape[1] + 3), dtype=x.dtype,
                      device=x.device)
    big[:, 1:x.shape[1] + 1] = x
    return big[:, 1:x.shape[1] + 1]


# (M, K, N): ragged shapes, the decode tile's edges (M = 1, 16), the wide
# tile's first and a ragged M (17, 130), the training shape (2048), K = 0
GATED_SHAPES = [(5, 37, 19), (4, 1024, 3072), (70, 100, 65), (1, 1024, 3072),
                (16, 1024, 3072), (17, 301, 1031), (130, 1024, 3072),
                (2048, 1024, 3072), (4, 0, 3072), (2048, 0, 1024)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mkn", GATED_SHAPES)
def test_gated_matmul_kernel_matches_plain(dev, dtype, mkn):
    """Every tile plan, each also through offset views of A and of the
    two weights (one row stride): the element-by-element loads, and the
    wide plan's mma.sync tile. K = 0 gives H = 0."""
    m, k, n = mkn
    a = _randn(m, k, dtype=dtype, dev=dev, seed=0)
    wg = _randn(k, n, dtype=dtype, dev=dev, seed=1, scale=max(k, 1) ** -0.5)
    wu = _randn(k, n, dtype=dtype, dev=dev, seed=2, scale=max(k, 1) ** -0.5)
    want = ref.gated_matmul_ref(a, wg, wu)
    _close(ops.gated_matmul(a, wg, wu), want, dtype)
    w = _offset(torch.cat([wg, wu], 1))
    _close(ops.gated_matmul(_offset(a), w[:, :n], w[:, n:]), want, dtype)
    if k == 0:
        assert not ops.gated_matmul(a, wg, wu).any()


@pytest.mark.parametrize("m, mma", [(17, "wgmma.m64n128k16"),
                                    (2047, "wgmma.m64n256k16")])
def test_gated_matmul_wide_tile_ragged_edges(dev, m, mma):
    """The dual GEMM's TMA + wgmma tile at both widths (the plan takes
    64 columns of each at M = 17, 128 at M = 2047), with ragged M, K and
    N and leading dims padded to 16 bytes: the zero fill past the edges
    of A and of both weights' boxes."""
    from repro_torch.kernels import matmul as tmm
    k, n = 301, 1031
    assert tmm.gated_tile_plan(m, k, n).mma == mma
    a = _randn(m, k + 3, dtype=torch.bfloat16, dev=dev, seed=0)[:, :k]
    w = _randn(k, 2 * 1040, dtype=torch.bfloat16, dev=dev, seed=1,
               scale=k ** -0.5)
    wg, wu = w[:, :n], w[:, 1040:1040 + n]
    got = ops.gated_matmul(a, wg, wu)
    _close(got, ref.gated_matmul_ref(a, wg, wu), torch.bfloat16)


@pytest.mark.parametrize("kn", [(1024, 3072)])
def test_gated_matmul_is_batch_invariant(dev, kn):
    """A row of H has the same bits at M = 4, 20 (a verify step), 136 and
    2048 as alone at M = 1: the decode tile (mma.sync) and the wide tiles
    (wgmma, 64 and 128 columns of H) sum k in one order, and the flush is
    the same arithmetic in all."""
    k, n = kn
    a = _randn(2048, k, dtype=torch.bfloat16, dev=dev, seed=0)
    wg = _randn(k, n, dtype=torch.bfloat16, dev=dev, seed=1, scale=k ** -0.5)
    wu = _randn(k, n, dtype=torch.bfloat16, dev=dev, seed=2, scale=k ** -0.5)
    rows = [0, 3, 135, 2047]
    alone = {r: ops.gated_matmul(a[r:r + 1], wg, wu) for r in rows}
    for m in (4, 20, 136, 2048):
        h = ops.gated_matmul(a[:m], wg, wu)
        for r in rows:
            if r < m:
                assert torch.equal(h[r:r + 1], alone[r]), (m, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 37, 4, 4, 16), (4, 100, 8, 2, 64),
                                   (2, 300, 16, 8, 128), (2, 130, 16, 2, 64),
                                   (4, 2048, 32, 32, 64)])
@pytest.mark.parametrize("window", [None, 7])
def test_flash_decode_kernel_matches_plain(dev, dtype, shape, window):
    """GQA groups 1, 2, 4 and 8 (more query heads than a block takes in
    one pass over its staged rows), and zamba2's decode shape: 32 heads of
    64, one query head a KV head, 2048 keys deep."""
    b, tk, h, hkv, d = shape
    q = _randn(b, 1, h, d, dtype=dtype, dev=dev, seed=0)
    # the cache as the model holds it: one layer's view of (L, B, T, Hkv, D)
    big_k = _randn(2, b, tk, hkv, d, dtype=dtype, dev=dev, seed=1)
    big_v = _randn(2, b, tk, hkv, d, dtype=dtype, dev=dev, seed=2)
    k, v = big_k[1], big_v[1]
    # idle, mid, first, past the end (every key, or the window's last)
    pos = torch.tensor([-1, tk // 2, 0, tk + 5][:b], dtype=torch.int32,
                       device=dev)
    got = ops.flash_decode(q, k, v, pos=pos, window=window)
    want = ref.attention_fwd_ref(q, k, v, window=window, q_offset=pos)
    _close(got, want, dtype)
    assert not got[0].any(), "an idle slot (pos < 0) must give zeros"
    _close(ops.flash_decode(q, k, v, pos=tk // 3, window=window),
           ref.attention_fwd_ref(q, k, v, window=window, q_offset=tk // 3),
           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("mkn", [(5, 37, 19), (4, 1024, 3072), (70, 100, 65),
                                 (129, 33, 257), (1, 1024, 1024),
                                 (16, 2048, 1024), (17, 301, 1031),
                                 (130, 1024, 3072), (2048, 3072, 1024),
                                 (4, 2048, 8192), (4, 2560, 10240),
                                 (4, 4096, 2048), (4, 2560, 336),
                                 (300, 2048, 8192)])
def test_matmul_q_kernel_matches_plain(dev, dtype, epilogue, mkn):
    """Every tile plan (the decode tile's widths and edges at M = 1 and
    16, the 128-row tile from M = 17), each also through offset views of
    A and of the int8 weight: the element-by-element loads; and the
    int8 Mamba projections at decode and prefill (zamba2's and
    mamba2-2.7b's in_proj, zamba2's shared in_proj at K = 4096, mamba2's
    in_proj_bc)."""
    m, k, n = mkn
    a = _randn(m, k, dtype=dtype, dev=dev, seed=0)
    wq, scale = precision.quantize_int8(
        _randn(k, n, dtype=torch.float32, dev=dev, seed=1, scale=k ** -0.5))
    kw = {}
    if epilogue == "residual":
        kw["residual"] = _randn(m, n, dtype=dtype, dev=dev, seed=2)
    elif epilogue != "none":
        kw["bias"] = _randn(n, dtype=torch.float32, dev=dev, seed=3)
    for out_dtype in (dtype, torch.float32):
        want = ref.matmul_q_ref(a, wq, scale, out_dtype, epilogue,
                                kw.get("bias"), kw.get("residual"))
        for a_, wq_ in ((a, wq), (_offset(a), _offset(wq))):
            got = ops.matmul_q(a_, wq_, scale, out_dtype=out_dtype,
                               epilogue=epilogue, **kw)
            _close(got, want,
                   out_dtype if out_dtype == dtype else torch.float32)


#: The QKV projections with bias of the configs with qkv_bias, at decode:
#: qwen2-vl-2b's Q (K = N = 1536) and K/V (N = 256), qwen1.5-32b's Q/K/V
#: (K = N = 5120).
QKV_BIAS_KN = [(1536, 1536), (1536, 256), (5120, 5120)]


@pytest.mark.parametrize("kn", QKV_BIAS_KN)
@pytest.mark.parametrize("m", [1, 4, 20])
def test_bias_epilogue_at_decode_shapes(dev, kn, m):
    """The bf16 GEMM and the int8-weight GEMM with the bias epilogue at a
    decode step's rows (4 slots; 20: a verify step of 5 rows a slot)
    against their plain versions, bf16 out, the bias in f32 (the served
    params keep it so) and in bf16; each row the bits of the same row
    alone (M = 1)."""
    k, n = kn
    a = _randn(m, k, dtype=torch.bfloat16, dev=dev, seed=0)
    w = _randn(k, n, dtype=torch.float32, dev=dev, seed=1, scale=k ** -0.5)
    wq, scale = precision.quantize_int8(w)
    w = w.to(torch.bfloat16)
    for bias_dtype in (torch.float32, torch.bfloat16):
        _check_bias_rows(a, w, wq, scale, _randn(
            n, dtype=bias_dtype, dev=dev, seed=2))


def _check_bias_rows(a, w, wq, scale, bias):
    m = a.shape[0]
    got = ops.matmul(a, w, epilogue="bias", bias=bias)
    _close(got, ref.fused_matmul_ref(a, w, torch.bfloat16, "bias", bias),
           torch.bfloat16)
    got_q = ops.matmul_q(a, wq, scale, out_dtype=torch.bfloat16,
                         epilogue="bias", bias=bias)
    _close(got_q, ref.matmul_q_ref(a, wq, scale, torch.bfloat16, "bias",
                                   bias), torch.bfloat16)
    for r in (0, m - 1):
        assert torch.equal(got[r:r + 1], ops.matmul(
            a[r:r + 1], w, epilogue="bias", bias=bias)), r
        assert torch.equal(got_q[r:r + 1], ops.matmul_q(
            a[r:r + 1], wq, scale, out_dtype=torch.bfloat16, epilogue="bias",
            bias=bias)), r


@pytest.mark.parametrize("kn", [(1024, 3072), (1024, 1024), (2048, 1024),
                                (3072, 1024), (2048, 8192), (2560, 10240)])
def test_matmul_q_is_batch_invariant(dev, kn):
    """A row of C has the same bits at M = 4, 20 (a verify step), 136 and
    2048 as alone at M = 1, with the residual epilogue, in bf16 and f32
    out: the decode tile and the 128-row tile sum k in one order (int8
    widened to bf16, k16 steps ascending), whatever the decode tile's
    width."""
    k, n = kn
    a = _randn(2048, k, dtype=torch.bfloat16, dev=dev, seed=0)
    wq, scale = precision.quantize_int8(
        _randn(k, n, dtype=torch.float32, dev=dev, seed=1, scale=k ** -0.5))
    res = _randn(2048, n, dtype=torch.bfloat16, dev=dev, seed=2)
    rows = [0, 3, 135, 2047]
    for out_dtype in (torch.bfloat16, torch.float32):
        def run(lo, hi):
            return ops.matmul_q(a[lo:hi], wq, scale, out_dtype=out_dtype,
                                epilogue="residual", residual=res[lo:hi])
        alone = {r: run(r, r + 1) for r in rows}
        for m in (4, 20, 136, 2048):
            c = run(0, m)
            for r in rows:
                if r < m:
                    assert torch.equal(c[r:r + 1], alone[r]), (m, r, out_dtype)


def _paged(k, v, ps, pos, seed, n_layers=2, layer=1):
    """k/v [B, Tk, Hkv, D] scattered into shuffled pages of layer `layer`
    of an (L, P, ps, Hkv, D) stack; the table maps each slot's pages up
    to its pos and holds -1 past them. Returns (kp, vp, table) with kp,
    vp the layer's views."""
    b, tk, hkv, d = k.shape
    pp = tk // ps
    n_pages = b * pp + 3
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n_pages, generator=g)
    big = [torch.zeros((n_layers, n_pages, ps, hkv, d), dtype=k.dtype,
                       device=k.device) for _ in range(2)]
    table = torch.full((b, pp), -1, dtype=torch.int32)
    for i in range(b):
        for j in range(pp):
            phys = int(perm[i * pp + j])
            big[0][layer, phys] = k[i, j * ps:(j + 1) * ps]
            big[1][layer, phys] = v[i, j * ps:(j + 1) * ps]
            if j * ps <= max(int(pos[i]), -1):
                table[i, j] = phys
    return big[0][layer], big[1][layer], table.to(k.device)


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8-float32",
                                  "int8-bfloat16"])
@pytest.mark.parametrize("shape", [(3, 40, 4, 4, 16, 8), (4, 96, 8, 2, 64, 16),
                                   (4, 256, 16, 8, 128, 16)])
@pytest.mark.parametrize("window", [None, 7])
def test_flash_decode_paged_kernel_matches_plain(dev, pool, shape, window):
    b, tk, h, hkv, d, ps = shape
    dtype = getattr(torch, pool.split("-")[-1])
    q = _randn(b, 1, h, d, dtype=dtype, dev=dev, seed=0)
    k = _randn(b, tk, hkv, d, dtype=dtype, dev=dev, seed=1)
    v = _randn(b, tk, hkv, d, dtype=dtype, dev=dev, seed=2)
    pos = torch.tensor([-1, tk // 2, 0, tk - 1][:b], dtype=torch.int32,
                       device=dev)
    kp, vp, table = _paged(k, v, ps, pos, seed=3)
    kw = {}
    if pool.startswith("int8"):
        (kp, ks), (vp, vs) = precision.quantize_kv(kp), precision.quantize_kv(vp)
        kw = dict(ks=ks.transpose(1, 2).contiguous(),
                  vs=vs.transpose(1, 2).contiguous())
    got = ops.flash_decode_paged(q, kp, vp, table, pos=pos, window=window, **kw)
    want = ref.flash_decode_paged_ref(q, kp, vp, table, pos=pos,
                                      window=window, **kw)
    _close(got, want, dtype)
    assert not got[0].any(), "an idle slot (pos < 0) must give zeros"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_paged_equals_dense_bit_for_bit(dev, dtype):
    """A pool in the query's dtype holds the dense cache's values: the
    paged kernel gives the dense kernel's bits."""
    b, tk, h, hkv, d, ps = 4, 2048, 16, 8, 128, 16
    q = _randn(b, 1, h, d, dtype=dtype, dev=dev, seed=0)
    k = _randn(b, tk, hkv, d, dtype=dtype, dev=dev, seed=1)
    v = _randn(b, tk, hkv, d, dtype=dtype, dev=dev, seed=2)
    pos = torch.tensor([-1, 0, 700, 2047], dtype=torch.int32, device=dev)
    kp, vp, table = _paged(k, v, ps, pos, seed=3)
    for window in (None, 512):
        assert torch.equal(
            ops.flash_decode_paged(q, kp, vp, table, pos=pos, window=window),
            ops.flash_decode(q, k, v, pos=pos, window=window))


def _rows_case(dev, layout, dtype, shape, seed=0):
    """A multi-row decode case: q [B, 5, H, D], slots idle, young, deep and
    at the cache's end, n_valid 5, 3, 5, 1; `run(q, pos, n_valid)` on
    the dense cache or a shuffled pool (in q's dtype, or int8 with
    scales) mapped up to each slot's last row."""
    b, tk, h, hkv, d, ps = shape
    t = 5
    q = _randn(b, t, h, d, dtype=dtype, dev=dev, seed=seed)
    k = _randn(b, tk, hkv, d, dtype=dtype, dev=dev, seed=seed + 1)
    v = _randn(b, tk, hkv, d, dtype=dtype, dev=dev, seed=seed + 2)
    pos = torch.tensor([-1, 3, tk // 2, tk - 1][:b], dtype=torch.int32,
                       device=dev)
    n_valid = torch.tensor([5, 3, 5, 1][:b], dtype=torch.int32, device=dev)
    if layout == "dense":
        def run(qq, p, nv=None, window=None, plain=False):
            fn = ref.decode_rows_ref if plain else ops.flash_decode
            return fn(qq, k, v, pos=p, window=window, n_valid=nv)
        return q, pos, n_valid, run
    kp, vp, table = _paged(k, v, ps, (pos + t - 1).clamp(max=tk - 1), seed=3)
    kw = {}
    if layout == "paged-int8":
        (kp, ks), (vp, vs) = precision.quantize_kv(kp), precision.quantize_kv(vp)
        kw = dict(ks=ks.transpose(1, 2).contiguous(),
                  vs=vs.transpose(1, 2).contiguous())

    def run(qq, p, nv=None, window=None, plain=False):
        fn = ref.flash_decode_paged_ref if plain else ops.flash_decode_paged
        return fn(qq, kp, vp, table, pos=p, window=window, n_valid=nv, **kw)
    return q, pos, n_valid, run


@pytest.mark.parametrize("layout", ["dense", "paged", "paged-int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 40, 4, 4, 16, 8),
                                   (4, 256, 16, 8, 128, 16)])
@pytest.mark.parametrize("window", [None, 7])
def test_flash_decode_rows_match_plain(dev, layout, dtype, shape, window):
    """The decode kernels' multi-row form (a verify step: 5 rows a slot,
    some past n_valid) against its plain version; rows past n_valid and
    an idle slot's rows are zeros."""
    q, pos, n_valid, run = _rows_case(dev, layout, dtype, shape)
    got = run(q, pos, n_valid, window)
    _close(got, run(q, pos, n_valid, window, plain=True), dtype)
    for s in range(q.shape[0]):
        for r in range(q.shape[1]):
            if pos[s] < 0 or r >= n_valid[s]:
                assert not got[s, r].any(), (s, r)


@pytest.mark.parametrize("layout", ["dense", "paged", "paged-int8"])
@pytest.mark.parametrize("window", [None, 512])
def test_flash_decode_rows_match_one_row(dev, layout, window):
    """Row r of the multi-row kernel is the one-row kernel at pos + r, bit
    for bit, at the main path's shape (4 slots, 16 query and 8 KV heads
    of 128, 2048 keys, bf16): the verify step writes and reads the
    decode step's bits."""
    q, pos, n_valid, run = _rows_case(dev, layout, torch.bfloat16,
                                      (4, 2048, 16, 8, 128, 16))
    got = run(q, pos, n_valid, window)
    for r in range(q.shape[1]):
        p = torch.where((pos >= 0) & (r < n_valid), pos + r, -1) \
            .to(torch.int32)
        one = run(q[:, r:r + 1].contiguous(), p, window=window)
        assert torch.equal(got[:, r], one[:, 0]), r


@pytest.mark.parametrize("layout", ["dense", "paged-bfloat16", "paged-int8"])
@pytest.mark.parametrize("window", [None, 512])
def test_flash_decode_is_batch_invariant(dev, layout, window):
    """A slot's output row has the same bits alone at B=1 and inside B=4
    beside slots of other depths (in two orders), against a cache of
    pos + 1 keys (whole pages for a pool) or of 2048, and with its pages
    in another order: the engine's "streams equal each request alone"
    gate rests on it."""
    _check_decode_batch_invariance(dev, layout, window, 16, 8, 128)


@pytest.mark.parametrize("window", [None, 512])
def test_flash_decode_is_batch_invariant_at_zamba2_heads(dev, window):
    """The same at zamba2's decode shape (32 heads of 64, one query head a
    KV head), on the dense cache that the hybrid serves from."""
    _check_decode_batch_invariance(dev, "dense", window, 32, 32, 64)


#: Query heads over KV heads (of 128) in the decode steps of the dense
#: configs: qwen2-vl-2b 12/2 (a group of 6: a pass of 4 query heads over
#: the staged rows, then one of 2), granite-3-8b 32/8, granite-20b 48/1
#: (MQA: 12 passes) and qwen1.5-32b 40/40 (MHA).
CONFIG_HEADS = [(12, 2), (32, 8), (48, 1), (40, 40)]


@pytest.mark.parametrize("layout", ["dense", "paged", "paged-int8"])
@pytest.mark.parametrize("heads", CONFIG_HEADS)
def test_flash_decode_matches_plain_at_the_configs_heads(dev, layout, heads):
    """The one-row and the multi-row form (5 rows a slot, some past
    n_valid) against their plain versions at the dense configs' groups,
    bf16, 4 slots of up to 300 keys: the last pass of a group that 4 does
    not divide covers its remaining heads; rows past n_valid and an idle
    slot give zeros."""
    h, hkv = heads
    q, pos, n_valid, run = _rows_case(dev, layout, torch.bfloat16,
                                      (4, 304, h, hkv, 128, 16))
    got = run(q, pos, n_valid)
    _close(got, run(q, pos, n_valid, plain=True), torch.bfloat16)
    for s in range(q.shape[0]):
        for r in range(q.shape[1]):
            if pos[s] < 0 or r >= n_valid[s]:
                assert not got[s, r].any(), (s, r)
    one = run(q[:, :1].contiguous(), pos)
    _close(one, run(q[:, :1].contiguous(), pos, plain=True), torch.bfloat16)
    assert torch.equal(one[:, 0], got[:, 0])


@pytest.mark.parametrize("layout", ["dense", "paged-bfloat16", "paged-int8"])
@pytest.mark.parametrize("heads", [(12, 2), (48, 1)])
def test_flash_decode_is_batch_invariant_at_groups_of_6_and_48(dev, layout,
                                                               heads):
    """The same batch invariance at qwen2-vl-2b's group of 6 and
    granite-20b's of 48 (MQA), where a block takes its query heads in
    passes of 4 and the last pass is short (6) or one of 12 (48)."""
    _check_decode_batch_invariance(dev, layout, None, *heads, 128)


def _check_decode_batch_invariance(dev, layout, window, h, hkv, d):
    b, tk, ps = 4, 2048, 16
    q = _randn(b, 1, h, d, dtype=torch.bfloat16, dev=dev, seed=0)
    k = _randn(b, tk, hkv, d, dtype=torch.bfloat16, dev=dev, seed=1)
    v = _randn(b, tk, hkv, d, dtype=torch.bfloat16, dev=dev, seed=2)
    pos_list = [-1, 63, 700, 2047]

    def run(rows, depth, seed):
        """Slots `rows` of the cache, `depth` keys deep, as one batch."""
        pos = torch.tensor([pos_list[i] for i in rows], dtype=torch.int32,
                           device=dev)
        qb = q[rows].contiguous()
        kb, vb = k[rows, :depth].contiguous(), v[rows, :depth].contiguous()
        if layout == "dense":
            return ops.flash_decode(qb, kb, vb, pos=pos, window=window)
        kp, vp, table = _paged(kb, vb, ps, pos, seed=seed)
        kw = {}
        if layout == "paged-int8":
            (kp, ks), (vp, vs) = (precision.quantize_kv(kp),
                                  precision.quantize_kv(vp))
            kw = dict(ks=ks.transpose(1, 2).contiguous(),
                      vs=vs.transpose(1, 2).contiguous())
        return ops.flash_decode_paged(qb, kp, vp, table, pos=pos,
                                      window=window, **kw)

    together = run([0, 1, 2, 3], tk, seed=3)
    reversed_ = run([3, 2, 1, 0], tk, seed=4).flip(0)
    assert not together[0].any(), "an idle slot (pos < 0) must give zeros"
    for i, p in enumerate(pos_list):
        assert torch.equal(reversed_[i], together[i]), (i, "batch order")
        if p < 0:
            continue
        shallow = -(-(p + 1) // ps) * ps if layout != "dense" else p + 1
        for depth, seed in ((tk, 5), (shallow, 6)):
            alone = run([i], depth, seed=seed)
            assert torch.equal(alone[0], together[i]), (i, depth)


def test_each_wrapper_counts_one_launch(dev):
    a = torch.ones(3, 8, device=dev)
    w = torch.ones(8, 5, device=dev)
    ops.reset_launch_counts()
    ops.matmul(a, w)
    ops.matmul_q(a, w.to(torch.int8), torch.ones(5, device=dev))
    ops.gated_matmul(a, w, w)
    ops.matmul_batched(a[None].expand(2, 3, 8), w[None].expand(2, 8, 5))
    ops.gated_matmul_batched(a[None].expand(2, 3, 8), w[None].expand(2, 8, 5),
                             w[None].expand(2, 8, 5))
    q = torch.ones(1, 1, 2, 16, device=dev)
    kv = torch.ones(1, 4, 2, 16, device=dev)
    ops.flash_decode(q, kv, kv, pos=2)
    table = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    ops.flash_decode_paged(q, kv, kv, table, pos=2)
    q3 = torch.ones(1, 3, 2, 16, device=dev)
    ops.flash_decode(q3, kv, kv, pos=0)
    ops.flash_decode_paged(q3, kv, kv, table, pos=0)
    o, lse = ops.flash_attention_fwd(kv, kv, kv)
    ops.flash_attention_bwd(kv, kv, kv, o, o, lse)
    ops.ssd(torch.ones(1, 4, 2, 3, device=dev), -torch.ones(1, 4, 2, device=dev),
            torch.ones(1, 4, 1, 5, device=dev), torch.ones(1, 4, 1, 5, device=dev), 2)
    ops.matmul_naive(a, w)
    ops.add(a, a)
    ops.axpy(2.0, a, a)
    assert ops.launch_counts() == {"matmul": 1, "matmul_q": 1,
                                   "gated_matmul": 1, "matmul_batched": 1,
                                   "gated_matmul_batched": 1,
                                   "flash_decode": 1,
                                   "flash_decode_paged": 1,
                                   "flash_decode_rows": 1,
                                   "flash_decode_paged_rows": 1,
                                   "flash_attention": 1,
                                   "flash_attention_bwd": 1, "ssd": 1,
                                   "matmul_naive": 1, "binary_op": 1,
                                   "axpy": 1}


def test_kernels_refuse_what_they_do_not_take(dev):
    a64 = torch.ones(2, 3, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        ops.matmul(a64, a64.t())
    a = torch.ones(4, 6, device=dev)[:, ::2]         # strided last dim
    with pytest.raises(ValueError):
        ops.matmul(a, torch.ones(3, 2, device=dev))
    with pytest.raises(ValueError):
        ops.matmul(torch.ones(2, 3, device=dev), torch.ones(3, 4))
    w = torch.ones(5, 3, device=dev).t()             # an [N, K] weight
    with pytest.raises(ValueError, match="row-major"):
        ops.gated_matmul(torch.ones(2, 3, device=dev), w, w)
    wq = torch.ones(5, 3, dtype=torch.int8, device=dev).t()   # [N, K]
    with pytest.raises(ValueError, match="row-major"):
        ops.matmul_q(torch.ones(2, 3, device=dev), wq,
                     torch.ones(5, device=dev))
    q = torch.ones(1, 1, 2, 16, device=dev)
    kp = torch.ones(2, 4, 2, 16, dtype=torch.bfloat16, device=dev)
    table = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError, match="pool"):
        ops.flash_decode_paged(q, kp, kp, table, pos=2)
    with pytest.raises(ValueError, match="table"):
        ops.flash_decode_paged(q, kp.float(), kp.float(), table.long(), pos=2)


def test_decode_step_on_card_matches_cpu(dev):
    """The reduced model in f32: a prefill and a per-slot decode step on
    the card (CUDA kernels) against the same on the CPU (plain versions)."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    pos = torch.tensor([12, -1], dtype=torch.int32)
    out = {}
    for d in ("cpu", "cuda"):
        p = _to(params, d)
        cache = M.init_cache(cfg, 2, 16, d)
        lp, cache = M.prefill(cfg, p, {"tokens": tokens.to(d)}, cache)
        ld, cache = M.decode_step(cfg, p, tokens[:, :1].to(d), pos.to(d), cache)
        out[d] = (lp.cpu(), ld[:1].cpu(), cache["k"].cpu(), cache["v"].cpu())
    for x, y in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-4)


def test_paged_int8_decode_step_on_card_matches_cpu(dev):
    """The reduced model in f32 with int8 weights, a step on an int8 page
    pool on the card against the same on the CPU: the write lands in the
    same pages and the logits agree."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              dtype="float32")
    params = M.quantize_params(
        M.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    tok = torch.tensor([[3], [7], [9]])
    pos = torch.tensor([5, -1, 12], dtype=torch.int32)
    table = torch.tensor([[4, 1, -1, -1], [-1, -1, -1, -1], [0, 2, 5, 3]],
                         dtype=torch.int32)
    out = {}
    for d in ("cpu", "cuda"):
        cache = M.init_paged_cache(cfg, 6, 4, 3, 4, quant_kv="int8", device=d)
        cache["table"] = table.to(d)
        log, cache = M.decode_step(cfg, _to(params, d), tok.to(d), pos.to(d),
                                   cache)
        out[d] = (log[[0, 2]].cpu(),
                  *(cache["pages"][n].cpu() for n in ("ks", "vs")))
    for x, y in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_on_card_matches_cpu(dev, accum):
    """The reduced model in f32: two AdamW steps on the card (the GEMM
    autograd and the flash attention pair on their kernels) against the
    same on the CPU: losses, grad norms and gradients agree."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 40), generator=
                                     torch.Generator().manual_seed(1))}
    batch["labels"] = batch["tokens"].roll(-1, 1)
    batch["labels"][:, -1] = -1
    opt = AdamW(lr=1e-3)
    out = {}
    for d in ("cpu", "cuda"):
        p = _to(params, d)
        b = _to(batch, d)
        _, _, grads = TL._loss_and_grads(cfg, p, b)
        step = TL.make_train_step(cfg, opt, accum=accum)
        state = TL.TrainState(p, opt.init(p))
        mets = []
        for _ in range(2):
            state, met = step(state, b)
            mets.append([float(met["loss"]), float(met["grad_norm"])])
        out[d] = (mets, _to(grads, "cpu"))
    torch.testing.assert_close(torch.tensor(out["cuda"][0]),
                               torch.tensor(out["cpu"][0]), atol=0, rtol=1e-5)
    for x, y in zip(leaves(out["cuda"][1]), leaves(out["cpu"][1])):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-1.2b"])
def test_recurrent_train_step_on_card_matches_cpu(dev, arch):
    """The reduced mamba2 and zamba2 (4 layers: two segments, lora_b from a
    seed) in f32, at a ragged 40 tokens (the SSD chunk pads): two donated
    AdamW steps of two microbatches each on the card (the GEMM autograd,
    the SSD Function and, for zamba2, the flash attention pair on their
    kernels, each layer rematerialised) against the same on the CPU:
    losses, grad norms and the first step's gradients agree."""
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=4)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if cfg.family == "hybrid":
        lb = params["hybrid"]["lora_b"]
        params["hybrid"]["lora_b"] = torch.randn(
            lb.shape, generator=torch.Generator().manual_seed(3)) \
            * lb.shape[1] ** -0.5
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 40), generator=
                                     torch.Generator().manual_seed(1))}
    batch["labels"] = batch["tokens"].roll(-1, 1)
    batch["labels"][:, -1] = -1
    opt = AdamW(lr=1e-3)
    out = {}
    for d in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(d, copy=True), params)  # donated below
        b = _to(batch, d)
        _, _, grads = TL._loss_and_grads(cfg, p, b)
        step = TL.make_train_step(cfg, opt, accum=2, donate=True)
        state = TL.TrainState(p, opt.init(p))
        mets = []
        for _ in range(2):
            state, met = step(state, b)
            mets.append([float(met["loss"]), float(met["grad_norm"])])
        out[d] = (mets, _to(grads, "cpu"))
    torch.testing.assert_close(torch.tensor(out["cuda"][0]),
                               torch.tensor(out["cpu"][0]), atol=0, rtol=1e-5)
    for x, y in zip(leaves(out["cuda"][1]), leaves(out["cpu"][1])):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=1e-4)


# (B, L, H, G, P, N, chunk): mamba2-2.7b's prefill at L = 512, one ragged
# chunk of 200, chunks of 8 and 2, groups of 4 heads read through strides,
# zamba2's d_state 64 and chunk 128
SSD_SHAPES = [(1, 512, 80, 1, 64, 128, 256), (1, 200, 80, 1, 64, 128, 200),
              (1, 8, 80, 1, 64, 128, 8), (1, 2, 80, 1, 64, 128, 2),
              (2, 96, 8, 2, 64, 128, 32), (1, 256, 64, 1, 64, 64, 128),
              (2, 48, 4, 2, 16, 16, 16)]


def _ssd_inputs(dev, shape, dtype=torch.float32, decay=(0.01, 0.5)):
    """x ~ N(0, 1), B and C scaled so that C . B ~ N(0, 1), log-decays
    -a ~ U(decay) (a constant for a one-value range)."""
    b, l, h, g, p, n, _ = shape
    x = _randn(b, l, h, p, dtype=dtype, dev=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    lo, hi = decay
    a = -(lo + (hi - lo) * torch.rand((b, l, h), generator=gen, device=dev))
    bm = _randn(b, l, g, n, dtype=dtype, dev=dev, seed=2, scale=n ** -0.25)
    cm = _randn(b, l, g, n, dtype=dtype, dev=dev, seed=3, scale=n ** -0.25)
    return x, a, bm, cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_intra_chunk_kernel_matches_plain(dev, dtype, shape):
    """Both outputs are f32 sums of the same (bf16-rounded) inputs."""
    from repro_torch.kernels import ssd as kssd
    x, a, bm, cm = _ssd_inputs(dev, shape, dtype)
    chunk = shape[-1]
    got = kssd.ssd_intra_chunk(x, a, bm, cm, chunk)
    want = ref.ssd_intra_chunk_ref(x, a, bm, cm, chunk)
    for g_, w_ in zip(got, want):
        _close(g_, w_, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_scan_on_card_matches_plain(dev, dtype, shape):
    """ops.ssd (the kernel, then the inter-chunk scan) against the plain
    chunked scan, from a carried state: y in the input dtype, the final
    state f32."""
    x, a, bm, cm = _ssd_inputs(dev, shape, dtype)
    b, _, h, _, p, n, chunk = shape
    s0 = _randn(b, h, p, n, dtype=torch.float32, dev=dev, seed=4)
    y, s = ops.ssd(x, a, bm, cm, chunk, init_state=s0)
    want_y, want_s = ref.ssd_chunked_ref(x, a, bm, cm, chunk, s0)
    _close(y, want_y, dtype)
    _close(s, want_s, torch.float32)


def test_ssd_strong_decay_is_finite(dev):
    """a = -20 a step: exp(cs_i - cs_j) above the diagonal would overflow
    unless masked before the exp."""
    shape = SSD_SHAPES[0]
    x, a, bm, cm = _ssd_inputs(dev, shape, decay=(20.0, 20.0))
    y, s = ops.ssd(x, a, bm, cm, shape[-1])
    want_y, want_s = ref.ssd_chunked_ref(x, a, bm, cm, shape[-1])
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    _close(y, want_y, torch.float32)
    _close(s, want_s, torch.float32)


def test_ssd_kernel_is_deterministic(dev):
    from repro_torch.kernels import ssd as kssd
    x, a, bm, cm = _ssd_inputs(dev, SSD_SHAPES[0])
    first = kssd.ssd_intra_chunk(x, a, bm, cm, 256)
    for _ in range(3):
        again = kssd.ssd_intra_chunk(x, a, bm, cm, 256)
        assert all(torch.equal(u, v) for u, v in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [SSD_SHAPES[0], SSD_SHAPES[1],
                                   SSD_SHAPES[-1]])
def test_ssd_is_batch_invariant(dev, dtype, shape):
    """Each element of a batch of 2 and of 3 gives its batch-1 bits, for
    y_diag and the states: the kernel's partition of a (batch, head,
    chunk) unit depends on (Q, N, P) only, and each output is summed by
    one warp in one order."""
    from repro_torch.kernels import ssd as kssd
    _, l, h, g, p, n, chunk = shape
    x, a, bm, cm = _ssd_inputs(dev, (3, l, h, g, p, n, chunk), dtype)
    alone = [kssd.ssd_intra_chunk(*(t[i:i + 1].contiguous()
                                    for t in (x, a, bm, cm)), chunk)
             for i in range(3)]
    for bsz in (2, 3):
        got = kssd.ssd_intra_chunk(x[:bsz], a[:bsz], bm[:bsz], cm[:bsz],
                                   chunk)
        for i in range(bsz):
            assert all(torch.equal(u[i:i + 1], v)
                       for u, v in zip(got, alone[i])), (bsz, i)


def test_ssd_f32_is_not_tf32(dev):
    """The f32 kernel at the main path's shape against the plain version
    on f64 copies of its inputs: its max error is within 4x the plain f32
    version's (one tf32 pass, ~3 digits, is far outside)."""
    from repro_torch.kernels import ssd as kssd
    shape = SSD_SHAPES[0]
    x, a, bm, cm = _ssd_inputs(dev, shape)
    chunk = shape[-1]
    exact = ref.ssd_intra_chunk_ref(x.double(), a.double(), bm.double(),
                                    cm.double(), chunk)
    got = kssd.ssd_intra_chunk(x, a, bm, cm, chunk)
    plain = ref.ssd_intra_chunk_ref(x, a, bm, cm, chunk)
    for k, p_, e in zip(got, plain, exact):
        err_k = (k.double() - e).abs().max().item()
        err_p = (p_.double() - e).abs().max().item()
        assert err_k <= 4 * err_p, (err_k, err_p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 128, 6, 2, 64, 128, 64),
                                   (1, 96, 3, 1, 40, 20, 96),
                                   (1, 256, 4, 1, 128, 256, 256)])
def test_ssd_unpaired_and_wide_heads_match_plain(dev, dtype, shape):
    """The kernel's other instances: an odd number of heads to a group
    (each block serves one head, not a pair), a ragged P and N, and P =
    128 with N = 256 (one head a block, the widest tiles)."""
    from repro_torch.kernels import ssd as kssd
    x, a, bm, cm = _ssd_inputs(dev, shape, dtype)
    chunk = shape[-1]
    got = kssd.ssd_intra_chunk(x, a, bm, cm, chunk)
    want = ref.ssd_intra_chunk_ref(x, a, bm, cm, chunk)
    for g_, w_ in zip(got, want):
        _close(g_, w_, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_unaligned_operands_take_the_plain_copy(dev, dtype):
    """x, B and C one element off a 16-byte boundary, with odd strides:
    the kernel stages them by a plain copy instead of cp.async."""
    from repro_torch.kernels import ssd as kssd
    b, l, h, g, p, n, chunk = 1, 200, 8, 2, 64, 128, 200
    xw = _randn(b, l, h, p + 1, dtype=dtype, dev=dev, seed=0)
    bcw = _randn(b, l, g, 2 * n + 1, dtype=dtype, dev=dev, seed=2,
                 scale=n ** -0.25)
    x, bm, cm = xw[..., 1:], bcw[..., 1:n + 1], bcw[..., n + 1:]
    a = -(0.01 + 0.49 * torch.rand((b, l, h), device=dev,
                                   generator=torch.Generator(device=dev)
                                   .manual_seed(1)))
    got = kssd.ssd_intra_chunk(x, a, bm, cm, chunk)
    want = ref.ssd_intra_chunk_ref(x, a, bm, cm, chunk)
    for g_, w_ in zip(got, want):
        _close(g_, w_, torch.float32)


def test_ssd_on_card_refuses_a_gradient(dev):
    """A recorded call on the card no longer refuses: it goes through the
    SSD Function (the kernel's forward), and its gradients equal autograd
    of the plain chunked scan on the card."""
    _ssd_grads_match_plain(dev, SSD_SHAPES[-1], with_state=True)


def _ssd_grads_match_plain(dev, shape, with_state=False, decay=(0.01, 0.5)):
    """The gradients of x, a, b, c (and the initial state) through
    core.ssd.ssd on the card against torch.autograd of ref.ssd_chunked_ref
    on the card, for the same random cotangents of y and the final
    state: the Function's backward differentiates that composition, so
    they agree to the order of f32 sums (rtol 1e-5, atol 1e-5 x the
    largest |gradient|); y and the state against the plain scan."""
    from repro_torch.core import ssd as core_ssd
    b, l, h, _, p, n, chunk = shape
    ins = list(_ssd_inputs(dev, shape, decay=decay))
    ins.append(_randn(b, h, p, n, dtype=torch.float32, dev=dev, seed=4)
               if with_state else torch.zeros(b, h, p, n, device=dev))
    gy = _randn(b, l, h, p, dtype=torch.float32, dev=dev, seed=5)
    gs = _randn(b, h, p, n, dtype=torch.float32, dev=dev, seed=6)
    grads = {}
    for how in ("card", "plain"):
        ts = [t.detach().requires_grad_() for t in ins]
        fn = core_ssd.ssd if how == "card" else ref.ssd_chunked_ref
        y, s = fn(*ts[:4], chunk, ts[4])
        grads[how] = ([y.detach(), s.detach()]
                      + list(torch.autograd.grad((y, s), ts, (gy, gs))))
    for got, want in zip(grads["card"][:2], grads["plain"][:2]):
        _close(got, want, torch.float32)
    for got, want in zip(grads["card"][2:], grads["plain"][2:]):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


# phase 3's SSD shapes: mamba2-2.7b at 512 tokens, a ragged chunk of 200,
# zamba2's d_state 64 and chunk 128, strong decays (a = -20)
@pytest.mark.parametrize("shape, with_state, decay", [
    (SSD_SHAPES[0], False, (0.01, 0.5)), (SSD_SHAPES[0], True, (0.01, 0.5)),
    (SSD_SHAPES[1], False, (0.01, 0.5)), (SSD_SHAPES[5], True, (0.01, 0.5)),
    (SSD_SHAPES[0], False, (20.0, 20.0))])
def test_ssd_gradients_on_card_match_plain_autograd(dev, shape, with_state,
                                                    decay):
    _ssd_grads_match_plain(dev, shape, with_state, decay)


@pytest.mark.parametrize("d", [64, 1024, 2560, 5120])
def test_rmsnorm_is_batch_invariant(dev, d):
    """Each row of 1, 2 or 3 normalises to the bits of the same row in a
    batch of 4 (qwen3's d_model 1024, mamba2's 2560 and its gated norm's
    5120)."""
    from repro_torch.models import layers as L
    p = {"scale": torch.rand(d, device=dev) + 0.5}
    for seed in range(50):
        x = _randn(4, 1, d, dtype=torch.bfloat16, dev=dev, seed=seed)
        full = L.rmsnorm_apply(p, x)
        for rows in (slice(0, 1), slice(0, 2), slice(0, 3), slice(3, 4)):
            assert torch.equal(L.rmsnorm_apply(p, x[rows]), full[rows])


def test_mamba_prefill_and_decode_on_card_match_cpu(dev):
    """The reduced mamba2 in f32: a prefill of a ragged prompt (padded to
    a chunk multiple) and two decode steps on the card against the same
    on the CPU: logits and every state leaf."""
    cfg = dataclasses.replace(get_config("mamba2-2.7b", reduced=True),
                              dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 21),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for d in ("cpu", "cuda"):
        p = _to(params, d)
        cache = M.init_cache(cfg, 2, 32, d)
        logs = [M.prefill(cfg, p, {"tokens": tokens.to(d)}, cache)[0]]
        for i in range(2):
            logs.append(M.decode_step(cfg, p, tokens[:, i:i + 1].to(d), 21 + i,
                                      cache)[0])
        out[d] = [t.cpu() for t in logs] + [v.cpu() for v in cache.values()]
    for x, y in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-4)


# (M, K, N): ragged edges on every side, a single row and column, K = 0
NAIVE_SHAPES = [(5, 37, 19), (70, 100, 65), (129, 33, 257), (1, 300, 1),
                (16, 0, 16), (1000, 300, 700)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("mkn", NAIVE_SHAPES)
def test_matmul_naive_kernel_matches_plain(dev, dtype, mkn):
    """f32 and f64 against the f64 product within K roundings of a
    partial sum of order 1 (atol K u, u = 2^-24 or 2^-53); bf16 (and an
    f32 output of bf16 inputs) against the plain version."""
    m, k, n = mkn
    a = _randn(m, k, dtype=dtype, dev=dev, seed=0)
    b = _randn(k, n, dtype=dtype, dev=dev, seed=1, scale=max(k, 1) ** -0.5)
    got = ops.matmul_naive(a, b)
    assert got.dtype == dtype and got.shape == (m, n)
    if dtype == torch.bfloat16:
        _close(got, ref.matmul_ref(a, b), dtype)
        _close(ops.matmul_naive(a, b, out_dtype=torch.float32),
               ref.matmul_ref(a, b, torch.float32), torch.float32)
        return
    u = 2.0 ** -53 if dtype == torch.float64 else 2.0 ** -24
    torch.testing.assert_close(got.double(), a.double() @ b.double(),
                               atol=max(k, 1) * u, rtol=0)


def test_matmul_naive_reads_row_strides(dev):
    """A and B as row slices of wider tensors: read through their row
    strides, no copy."""
    a = _randn(40, 64, dtype=torch.float32, dev=dev, seed=0)[:, :50]
    b = _randn(50, 96, dtype=torch.float32, dev=dev, seed=1)[:, 10:70]
    torch.testing.assert_close(ops.matmul_naive(a, b), ref.matmul_ref(a, b),
                               **TOL[torch.float32])


def _elementwise_operands(dev, dtype, numel, offset, seed):
    """A flat operand of `numel` elements starting `offset` elements into
    its buffer (offset 1: not on a 16-byte boundary)."""
    return _randn(numel + offset, dtype=dtype, dev=dev, seed=seed)[offset:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("numel", [0, 1, 17, 4096, 1000 * 1001])
@pytest.mark.parametrize("offset", [0, 1])
def test_binary_op_kernel_is_bit_exact(dev, dtype, op, numel, offset):
    from repro_torch.kernels import elementwise as kew
    x = _elementwise_operands(dev, dtype, numel, offset, 0)
    y = _elementwise_operands(dev, dtype, numel, offset, 1)
    assert torch.equal(kew.binary_op(x, y, op), ref.binary_ref(x, y, op))
    x2, y2 = x[: numel - numel % 7].view(-1, 7), y[: numel - numel % 7].view(-1, 7)
    assert torch.equal(kew.binary_op(x2, y2, op), ref.binary_ref(x2, y2, op))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("alpha", [0.7, -3.0, "tensor", "f32 tensor"])
@pytest.mark.parametrize("offset", [0, 1])
def test_axpy_kernel_is_bit_exact(dev, dtype, alpha, offset):
    x = _elementwise_operands(dev, dtype, 1000 * 1001, offset, 0)
    y = _elementwise_operands(dev, dtype, 1000 * 1001, offset, 1)
    if alpha == "tensor":
        alpha = torch.full((1,), 0.7, dtype=dtype, device=dev)
    elif alpha == "f32 tensor":
        alpha = torch.tensor(1.3, device=dev)
    assert torch.equal(ops.axpy(alpha, x, y), ref.saxpy_ref(alpha, x, y))


def test_complex_add_and_sub_through_the_real_kernel(dev):
    x = torch.complex(_randn(33, 65, dtype=torch.float32, dev=dev, seed=0),
                      _randn(33, 65, dtype=torch.float32, dev=dev, seed=1))
    y = torch.complex(_randn(33, 65, dtype=torch.float32, dev=dev, seed=2),
                      _randn(33, 65, dtype=torch.float32, dev=dev, seed=3))
    ops.reset_launch_counts()
    assert torch.equal(ops.add(x, y), x + y)
    assert torch.equal(ops.sub(x, y), x - y)
    assert ops.launch_counts()["binary_op"] == 2


def test_paper_kernels_refuse_what_they_do_not_take(dev):
    from repro_torch.kernels import elementwise as kew
    a = torch.ones(4, 6, device=dev)
    with pytest.raises(ValueError):
        ops.matmul_naive(a[:, ::2], torch.ones(3, 2, device=dev))
    with pytest.raises(TypeError):
        ops.matmul_naive(a, torch.ones(6, 2, device=dev, dtype=torch.float64))
    with pytest.raises(TypeError):
        ops.matmul_naive(a.double(), a.double().t(), out_dtype=torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.add(a[:, ::2], a[:, ::2])
    with pytest.raises(TypeError):
        kew.binary_op(a.half(), a.half())
    with pytest.raises(ValueError, match="alpha"):
        ops.axpy(torch.ones(2, device=dev), a, a)


def test_gemm_routes_complex_and_float64(dev):
    """complex64 by gauss3 over three tiled launches, float64 to the plain
    product (no launch); both against the product in f64/c128; the
    complex gradient is PyTorch's (conjugate) one."""
    from repro_torch.core import gemm
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(37, 50, dtype=torch.complex64, device=dev, generator=g)
    b = torch.randn(50, 29, dtype=torch.complex64, device=dev, generator=g)
    ops.reset_launch_counts()
    got = gemm.matmul(a, b)
    assert ops.launch_counts()["matmul"] == 3
    torch.testing.assert_close(got, (a.cdouble() @ b.cdouble()).cfloat(),
                               atol=1e-4, rtol=1e-4)
    a64, b64 = a.real.double(), b.real.double()
    ops.reset_launch_counts()
    assert torch.equal(gemm.matmul(a64, b64), a64 @ b64)
    assert sum(ops.launch_counts().values()) == 0
    ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
    gemm.matmul(ar, br).abs().sum().backward()
    aw, bw = a.clone().requires_grad_(), b.clone().requires_grad_()
    (aw @ bw).abs().sum().backward()
    torch.testing.assert_close(ar.grad, aw.grad, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(br.grad, bw.grad, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", [None, "silu", "gelu"])
def test_dense_q_gradient_on_card_matches_plain(dev, dtype, activation):
    """The gradients of x, scale, b and residual of dense_q on the card
    (`_DenseQ`: the int8-weight kernel forward, the backward's GEMMs on
    the tiled kernel) against autograd of the plain dequantized
    composition on the card, within 1e-4 (f32) or 2^-7 (bf16) x the
    largest |gradient|; the int8 weight takes none."""
    from repro_torch.core import gemm
    m, k, n = 70, 96, 130
    ops_ = [_randn(m, k, dtype=dtype, dev=dev, seed=0),
            None, _randn(n, dtype=dtype, dev=dev, seed=2),
            _randn(m, n, dtype=dtype, dev=dev, seed=3)]
    wq, ops_[1] = precision.quantize_int8(
        _randn(k, n, dtype=torch.float32, dev=dev, seed=1, scale=0.1))
    g = _randn(m, n, dtype=dtype, dev=dev, seed=4)
    got = [t.clone().requires_grad_() for t in ops_]
    ops.reset_launch_counts()
    gemm.dense_q(got[0], wq, got[1], got[2], activation=activation,
                 residual=got[3]).backward(g)
    torch.cuda.synchronize()
    # the forward, dx and dw (and the recompute under an activation)
    assert ops.launch_counts() == _no_launches(
        matmul_q=1, matmul=2 + (activation is not None))
    want = [t.clone().requires_grad_() for t in ops_]
    z = want[0] @ (wq.float() * want[1]).to(dtype) + want[2]
    if activation is not None:
        z = gemm._ACTIVATIONS[activation](z)
    (z + want[3]).backward(g)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    for name, a, b in zip(("x", "scale", "b", "residual"), got, want):
        assert a.grad.dtype == b.grad.dtype, name
        scale = max(b.grad.abs().max().item(), 1.0)
        assert (a.grad - b.grad).abs().max().item() <= tol * scale, name
    assert wq.grad is None


# ----------------------------------------------------------------------
# the serving engine's steps as CUDA graphs
# ----------------------------------------------------------------------

# the three serving paths, on reduced configs in the serving dtype (bf16)
SERVE_PATHS = {
    "dense": ("qwen3-0.6b", {}),
    "paged-int8": ("qwen3-0.6b", dict(kv_layout="paged", quant_kv="int8",
                                      quant="int8", page_size=8)),
    "mamba2": ("mamba2-2.7b", {}),
    "hybrid": ("zamba2-1.2b", {}),
    "mamba2-int8": ("mamba2-2.7b", dict(quant="int8")),
    "hybrid-int8": ("zamba2-1.2b", dict(quant="int8")),
}
# prompts with remainder tokens (13, 21), a whole bucket (16) and one
# shorter than a bucket (5, prefilled exactly)
SERVE_LENGTHS = (13, 21, 16, 5)


def _serving(dev, path, max_slots=2, max_len=48):
    arch, kw = SERVE_PATHS[path]
    cfg = get_config(arch, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    if cfg.family == "hybrid":
        # lora_b starts at zeros: draw it, so the LoRA path computes
        lb = params["hybrid"]["lora_b"]
        params["hybrid"]["lora_b"] = _randn(*lb.shape, dtype=lb.dtype,
                                            dev=dev, seed=9,
                                            scale=lb.shape[1] ** -0.5)
    eng = ServingEngine(cfg, params, max_slots=max_slots, max_len=max_len,
                        device=dev, **kw)
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).numpy()
               for n in SERVE_LENGTHS]
    return eng, prompts


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _assert_same(got, want):
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_same(got[k], v)
        else:
            assert torch.equal(got[k], v), k


def _no_launches(**counts):
    return {**dict.fromkeys(ops.launch_counts(), 0), **counts}


@pytest.mark.parametrize("path", list(SERVE_PATHS))
def test_replayed_steps_equal_eager_steps_bit_for_bit(dev, path):
    """After admissions (remainder tokens included) and decode steps, one
    replay of the decode graph gives an eager decode_step's logits and
    cache from a clone of the same state, bit for bit; a replay of the
    remainder graph gives the eager step's at the (1,) position vector
    and at the same position as a Python int (the slice write)."""
    eng, prompts = _serving(dev, path)
    cfg, params = eng.cfg, eng.params
    for p in prompts[:2]:
        eng.submit(p, 6)
    eng.step()                          # both admitted, one decode step
    eng.step()
    assert eng.scheduler.n_active == 2
    if eng.pool is not None:
        eng._prepare_pages(eng.scheduler.active)
    eng._step_tokens.copy_(eng._tokens_h)
    eng._step_pos.copy_(eng._pos_h)
    tok, pos = eng._step_tokens.clone(), eng._step_pos.clone()
    state = _clone(eng.cache)
    got = eng._step().clone()
    want, state = M.decode_step(cfg, params, tok, pos, state)
    assert torch.equal(got, want)
    _assert_same(eng.cache, state)

    toks = torch.as_tensor(prompts[0], dtype=torch.long, device=dev)[None]
    for leaf in leaves(eng._sub):
        leaf.zero_()
    M.prefill(cfg, params, {"tokens": toks[:, :8]}, eng._sub)
    vec, scalar = _clone(eng._sub), _clone(eng._sub)
    for i in range(8, toks.shape[1]):
        eng._rem_token.copy_(toks[:, i:i + 1])
        eng._rem_pos.fill_(i)
        got = eng._remainder_step().clone()
        want, vec = M.decode_step(cfg, params, toks[:, i:i + 1],
                                  eng._rem_pos.clone(), vec)
        assert torch.equal(got, want), i
        want, scalar = M.decode_step(cfg, params, toks[:, i:i + 1], i, scalar)
        assert torch.equal(got, want), i
        _assert_same(eng._sub, vec)
        _assert_same(eng._sub, scalar)


@pytest.mark.parametrize("path", list(SERVE_PATHS))
def test_replays_count_the_eager_launches(dev, path):
    """Launches over a run equal the eager formula: every prefill and
    every one-token step (decode, or an admission's remainder token)
    runs the path's GEMMs; the remainder steps decode on the dense
    sub-cache, the decode steps on the cache or the pool."""
    eng, prompts = _serving(dev, path)
    reqs = [eng.submit(p, 4) for p in prompts]
    ops.reset_launch_counts()
    eng.run()
    torch.cuda.synchronize()
    assert all(len(r.generated) == 4 for r in reqs)
    L, n = eng.cfg.n_layers, len(reqs)
    rem = sum(len(p) % 8 for p in prompts if len(p) >= 8)
    one = eng.decode_steps + rem
    if path == "mamba2":
        want = _no_launches(matmul=(5 * L + 1) * n + (3 * L + 1) * one,
                            ssd=L * n)
    elif path == "mamba2-int8":
        want = _no_launches(matmul_q=(5 * L + 1) * n + (3 * L + 1) * one,
                            ssd=L * n)
    elif path.startswith("hybrid"):
        # a segment: its Mamba layers (5 GEMMs at prefill, 3 a step), the
        # shared in_proj, the LoRA pair, QKV/O, the SwiGLU and down; with
        # int8 weights the block, its in_proj and lm_head take matmul_q
        # (the dual GEMM as two) and the Mamba stacks and LoRA stay bf16
        a, seg = eng.cfg.attn_every, L // eng.cfg.attn_every
        attn = dict(flash_decode=seg * one, ssd=L * n)
        if path == "hybrid":
            want = _no_launches(matmul=seg * (5 * a + 8) * n + n
                                + (seg * (3 * a + 8) + 1) * one,
                                gated_matmul=seg * (n + one), **attn)
        else:
            want = _no_launches(matmul=seg * (5 * a + 2) * n
                                + seg * (3 * a + 2) * one,
                                matmul_q=(8 * seg + 1) * (n + one), **attn)
    elif path == "dense":
        want = _no_launches(matmul=(5 * L + 1) * (one + n),
                            gated_matmul=L * (one + n), flash_decode=L * one)
    else:
        want = _no_launches(matmul_q=7 * L * (one + n), matmul=one + n,
                            flash_decode=L * rem,
                            flash_decode_paged=L * eng.decode_steps)
    assert ops.launch_counts() == want


def test_a_replayed_step_calls_no_kernel_wrapper(dev, monkeypatch):
    """A step is a replay: the kernel wrappers are not called, and the
    counts grow by what the capture recorded (141/28/28 at full width;
    5L + 1 GEMMs, L dual GEMMs and L decode attentions a step)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import matmul as kmm
    eng, prompts = _serving(dev, "dense")
    L = eng.cfg.n_layers
    step = {"matmul": 5 * L + 1, "gated_matmul": L, "flash_decode": L}
    assert eng._step.launches == step and eng._remainder_step.launches == step
    eng.submit(prompts[0], 4)
    eng.step()
    calls = []
    for mod, name in ((kmm, "matmul_tiled"), (kmm, "gated_matmul_tiled"),
                      (kfa, "flash_decode")):
        def counted(*args, _fn=getattr(mod, name), _name=name, **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, name, counted)
    before = ops.launch_counts()
    eng.step()
    eng._remainder_step()
    torch.cuda.synchronize()
    assert calls == []
    assert ops.launch_counts() == {k: n + 2 * step.get(k, 0)
                                   for k, n in before.items()}
    M.decode_step(eng.cfg, eng.params, eng._step_tokens.clone(),
                  eng._step_pos.clone(), _clone(eng.cache))
    # an eager step goes through the wrappers that the replays skipped
    assert sorted(set(calls)) == ["flash_decode", "gated_matmul_tiled",
                                  "matmul_tiled"]


def test_a_host_sync_in_the_step_makes_the_constructor_raise(dev,
                                                             monkeypatch):
    """A step path that syncs with the host (one op patched to call
    torch.cuda.synchronize) cannot be captured: the constructor raises
    and nothing runs the step eagerly. The launch counts and the current
    stream are as before, and the card captures the next engine."""
    from repro_torch.models import layers as L
    cfg = get_config("qwen3-0.6b", reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    rmsnorm = L.rmsnorm_apply

    def syncing(*args, **kw):
        torch.cuda.synchronize()
        return rmsnorm(*args, **kw)
    before = ops.launch_counts()
    monkeypatch.setattr(L, "rmsnorm_apply", syncing)
    with pytest.raises(RuntimeError, match="capturing the decode step"):
        ServingEngine(cfg, params, max_slots=2, max_len=32, device=dev)
    monkeypatch.undo()
    assert ops.launch_counts() == before
    assert torch.cuda.current_stream(dev) == torch.cuda.default_stream(dev)
    eng = ServingEngine(cfg, params, max_slots=2, max_len=32, device=dev)
    req = eng.submit(torch.arange(13).numpy(), 3)
    eng.run()
    assert len(req.generated) == 3


@pytest.mark.parametrize("path", ["hybrid", "paged-int8"])
def test_a_rebuild_mid_trace_keeps_the_fault_free_streams(dev, path,
                                                          monkeypatch):
    """Kernel faults at decode steps 1 and 4 with both slots busy: the
    second rebuilds the captured steps (the old graphs freed, the new
    ones captured at position -1, a Mamba state put back), and every
    stream is the fault-free run's. The new graphs launch what the old
    ones did, in as much pool memory, and memory_allocated does not
    grow by more than a graph pool."""
    from repro_torch.serving import FaultInjector
    from repro_torch.serving import engine as E
    eng, prompts = _serving(dev, path)
    reqs = [eng.submit(p, 6) for p in prompts]
    eng.run()
    want = [r.generated for r in reqs]
    kw = SERVE_PATHS[path][1]
    eng = ServingEngine(eng.cfg, eng.params, max_slots=2, max_len=48,
                        device=dev, **kw, fault_injector=FaultInjector(
                            kernel_fail_steps=(1, 4)))
    launches, pools = eng._step.launches, eng.graph_pool_bytes
    seen = {}
    rebuild = eng._rebuild_steps

    def measured(err):
        torch.cuda.synchronize()
        seen["active"] = eng.scheduler.n_active
        seen["before"] = torch.cuda.memory_allocated(dev)
        rebuild(err)
        torch.cuda.synchronize()
        seen["after"] = torch.cuda.memory_allocated(dev)
    # an instance attribute, taken out at teardown: the closure would
    # keep the engine alive in a reference cycle
    monkeypatch.setattr(eng, "_rebuild_steps", measured)
    monkeypatch.setattr(E, "_REBUILD_WARNED", True)
    reqs = [eng.submit(p, 6) for p in prompts]
    rep = eng.run()
    assert rep["degraded"] and rep["kernel_faults"] == 2, rep
    assert rep["crashed_steps"] == 0 and seen["active"] == 2, (rep, seen)
    assert [r.generated for r in reqs] == want
    assert eng._step.launches == launches
    biggest = max(eng._step.pool_bytes, eng._remainder_step.pool_bytes)
    assert eng.graph_pool_bytes <= pools + biggest, (eng.graph_pool_bytes,
                                                     pools)
    assert seen["after"] - seen["before"] <= biggest, seen


def test_an_engine_frees_its_graphs(dev):
    """Deleting an engine frees its graphs' memory with its caches. An
    earlier test's garbage (an engine in a reference cycle, say) is
    collected first, so that no collection during the test moves the
    count."""
    import gc
    cfg = get_config("qwen3-0.6b", reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    eng = ServingEngine(cfg, params, max_slots=2, max_len=32, device=dev)
    assert eng.graph_pool_bytes > 0 and eng.capture_s > 0
    del eng
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == base


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_hybrid_prefill_and_decode_on_card_match_cpu(dev):
    """The reduced zamba2 at 4 layers (two segments) in f32, a random
    lora_b: a prefill of a ragged prompt and two decode steps at a
    per-slot position vector (slot 1 idle at the second) on the card
    against the same on the CPU: logits of the active rows, the KV
    caches, and slot 0's Mamba state."""
    cfg = dataclasses.replace(get_config("zamba2-1.2b", reduced=True),
                              n_layers=4, dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lb = params["hybrid"]["lora_b"]
    params["hybrid"]["lora_b"] = torch.randn(
        lb.shape, generator=torch.Generator().manual_seed(3)) \
        * lb.shape[1] ** -0.5
    tokens = torch.randint(0, cfg.vocab, (2, 21),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for d in ("cpu", "cuda"):
        p = _to(params, d)
        cache = M.init_cache(cfg, 2, 32, d)
        logs = [M.prefill(cfg, p, {"tokens": tokens.to(d)}, cache)[0]]
        for i, pos in enumerate(([21, 21], [22, -1])):
            pos = torch.tensor(pos, dtype=torch.int32, device=d)
            logs.append(M.decode_step(cfg, p, tokens[:, i:i + 1].to(d), pos,
                                      cache)[0][:2 - i])
        out[d] = [t.cpu() for t in logs] \
            + [t.cpu() for t in leaves(cache["attn"])] \
            + [t[:, :, :1].cpu() for t in leaves(cache["mamba"])]
    for x, y in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_spec_engine_streams_equal_the_plain_engines(dev, kv_layout):
    """The speculative engine on the card, its decode, remainder and
    verify steps and the draft's two steps replays of CUDA graphs: with
    the target as its own draft and with a draft of other weights, its
    greedy streams equal the plain engine's, the self-draft accepts every
    proposal, and each round launches one multi-row decode attention a
    layer."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    other = M.init_params(cfg, torch.Generator().manual_seed(1), dev)
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).numpy()
               for n in SERVE_LENGTHS]
    kw = dict(max_slots=2, max_len=48, device=dev, kv_layout=kv_layout,
              page_size=8)

    def streams(**more):
        eng = ServingEngine(cfg, params, **kw, **more)
        reqs = [eng.submit(p, 7) for p in prompts]
        ops.reset_launch_counts()
        rep = eng.run()
        torch.cuda.synchronize()
        return [r.generated for r in reqs], rep, ops.launch_counts()

    want, _, _ = streams()
    for draft, full in ((params, True), (other, False)):
        got, rep, launches = streams(draft=(cfg, draft), spec_k=4)
        assert got == want
        assert (rep["spec_acceptance_rate"] == 1.0) == full
        name = "flash_decode_rows" if kv_layout == "dense" \
            else "flash_decode_paged_rows"
        assert launches[name] == cfg.n_layers * rep["spec_rounds"]


def test_replayed_verify_step_equals_the_eager_step_bit_for_bit(dev):
    """One replay of the verify graph, mid-run on a page pool, gives an
    eager verify_step's logits and pool from a clone of the same state,
    bit for bit."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    eng = ServingEngine(cfg, params, max_slots=2, max_len=48, device=dev,
                        kv_layout="paged", page_size=8,
                        draft=(cfg, params), spec_k=4)
    g = torch.Generator().manual_seed(2)
    for n in SERVE_LENGTHS[:2]:
        eng.submit(torch.randint(0, cfg.vocab, (n,), generator=g).numpy(), 12)
    eng.step()
    assert eng.scheduler.n_active == 2
    k_vec = np.full(2, 4, np.int32)
    drafts, _ = eng.spec.draft_round(eng._tokens, eng._pos, k_vec)
    vt, nt = eng._vtokens_h.numpy(), eng._ntok_h.numpy()
    vt[:, 0], vt[:, 1:], nt[:] = eng._tokens[:, 0], drafts, 5
    eng._prepare_pages(eng.scheduler.active, nt)
    eng._v_tokens.copy_(eng._vtokens_h)
    eng._step_pos.copy_(eng._pos_h)
    eng._v_ntok.copy_(eng._ntok_h)
    state = _clone(eng.cache)
    args = (eng._v_tokens.clone(), eng._step_pos.clone(), eng._v_ntok.clone())
    got = eng._verify_step().clone()
    want, _ = M.verify_step(cfg, eng.params, *args, state)
    assert torch.equal(got, want)
    _assert_same(eng.cache, state)


# ----------------------------------------------------------------------
# the moe family: the batched GEMM and dual GEMM over expert banks, the
# MoE layer, the engine, and decode attention at Arctic's group of 7
# ----------------------------------------------------------------------

# (E, M, K, N): decode (the 16-row tiles), a verify step's 20 rows, and
# prefill buckets (M = 160, mixtral's 512-token bucket: the TMA + wgmma
# tiles, ragged; N = 8448 takes the dual GEMM's 128-column tile)
BANK_SHAPES = [(3, 4, 64, 40), (2, 20, 96, 72), (3, 160, 128, 136),
               (2, 160, 64, 8448)]


def _bank(dev, e, m, k, n, dtype, seed=0):
    a = _randn(e, m, k, dtype=dtype, dev=dev, seed=seed)
    w = _randn(e, k, n, dtype=dtype, dev=dev, seed=seed + 1, scale=k ** -0.5)
    u = _randn(e, k, n, dtype=dtype, dev=dev, seed=seed + 2, scale=k ** -0.5)
    return a, w, u


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BANK_SHAPES)
def test_batched_gemms_match_plain_and_the_2d_kernels(dev, dtype, shape):
    """The batched GEMM and dual GEMM against their plain versions, and
    each expert's output equal to the 2-D kernel's on that expert's
    operands, bit for bit (the same tile plan on each expert)."""
    e, m, k, n = shape
    a, w, u = _bank(dev, e, m, k, n, dtype)
    c = ops.matmul_batched(a, w)
    h = ops.gated_matmul_batched(a, w, u)
    _close(c, ref.matmul_batched_ref(a, w), dtype)
    _close(h, ref.gated_matmul_batched_ref(a, w, u), dtype)
    for x in range(e):
        assert torch.equal(c[x], ops.matmul(a[x], w[x])), x
        assert torch.equal(h[x], ops.gated_matmul(a[x], w[x], u[x])), x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_gemms_are_batch_invariant(dev, dtype):
    """An expert's first 4 rows have the same bits at M = 4 (decode), 20
    and 160 (the wide tiles), in a bank of one layer of a stacked
    (L, E, K, N) tensor."""
    e, k, n = 3, 256, 320
    a, _, _ = _bank(dev, e, 160, k, n, dtype)
    stack = _randn(2, e, k, n, dtype=dtype, dev=dev, seed=5, scale=k ** -0.5)
    w, u = stack[1], stack[0]
    c4 = ops.matmul_batched(a[:, :4].contiguous(), w)
    h4 = ops.gated_matmul_batched(a[:, :4].contiguous(), w, u)
    for m in (20, 160):
        am = a[:, :m].contiguous()
        assert torch.equal(ops.matmul_batched(am, w)[:, :4], c4), m
        assert torch.equal(ops.gated_matmul_batched(am, w, u)[:, :4], h4), m


def _bank_view(dev, e, m, k, n, dtype, a_km, b_nk, seed=0):
    """A (E, M, K) and B (E, K, N) banks, each row-major or (a_km, b_nk)
    the transpose view of a row-major (E, K, M) or (E, N, K) bank."""
    a = _randn(e, *((k, m) if a_km else (m, k)), dtype=dtype, dev=dev,
               seed=seed)
    b = _randn(e, *((n, k) if b_nk else (k, n)), dtype=dtype, dev=dev,
               seed=seed + 1, scale=k ** -0.5)
    return (a.transpose(1, 2) if a_km else a,
            b.transpose(1, 2) if b_nk else b)


# (E, M, K, N): the 16-row tiles, the narrow and the TMA + wgmma tiles
# (ragged), a weight gradient's K of 640 slots, a 192-wide plan
BANK_T_SHAPES = [(3, 4, 64, 40), (2, 20, 96, 72), (3, 160, 128, 136),
                 (2, 384, 640, 200), (2, 256, 96, 1152)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BANK_T_SHAPES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_batched_gemm_layouts_match_plain_and_the_2d_kernel(dev, dtype, shape,
                                                            layout):
    """The batched GEMM on transpose views of its banks (A as a row-major
    (E, K, M) bank's, B as an (E, N, K) one's: a bank's backward), read
    in place: against the plain version, each expert's output equal to
    the 2-D kernel's on the same views bit for bit."""
    e, m, k, n = shape
    a, b = _bank_view(dev, e, m, k, n, dtype, *layout)
    c = ops.matmul_batched(a, b)
    _close(c, ref.matmul_batched_ref(a, b), dtype)
    for x in range(e):
        assert torch.equal(c[x], ops.matmul(a[x], b[x])), x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", LAYOUTS[1:])
def test_batched_gemm_layouts_are_batch_invariant(dev, dtype, layout):
    """In each transposed layout an expert's first 4 rows have the same
    bits at M = 4, 20 and 160."""
    e, k, n = 3, 256, 320
    a, b = _bank_view(dev, e, 160, k, n, dtype, *layout)
    c4 = ops.matmul_batched(a[:, :4], b)
    for m in (20, 160):
        assert torch.equal(ops.matmul_batched(a[:, :m], b)[:, :4], c4), m


def test_bank_gemms_on_card_refuse_a_gradient(dev, monkeypatch):
    """A recorded bank GEMM on the card no longer refuses: it goes through
    the bank Functions (the batched kernels; the backward 2 batched GEMMs
    for the GEMM, 6 for the dual GEMM, on the transposed layouts, no plain
    version launched). In f32 the gradients equal autograd of the plain
    versions on the card; in bf16 (whose recompute rounds gate and up to
    bf16, as the JAX package's VJP does) the same Functions with every
    GEMM through its plain version on the card."""
    from repro_torch.core import gemm
    for dtype in (torch.float32, torch.bfloat16):
        a, w, u = _bank(dev, 3, 160, 128, 136, dtype)
        ga = _randn(3, 160, 136, dtype=dtype, dev=dev, seed=7)
        for fn, plain, ins in (
                (gemm.matmul, ref.matmul_batched_ref, (a, w)),
                (gemm.gated_mlp, ref.gated_matmul_batched_ref, (a, w, u))):
            ops.reset_launch_counts()
            ts = [t.detach().requires_grad_() for t in ins]
            got = torch.autograd.grad(fn(*ts), ts, ga)
            counts = ops.launch_counts()
            assert (counts["matmul_batched"], counts["gated_matmul_batched"]) \
                == ((3, 0) if fn is gemm.matmul else (6, 1)), counts
            ts = [t.detach().requires_grad_() for t in ins]
            if dtype == torch.float32:
                want = torch.autograd.grad(plain(*ts), ts, ga)
            else:
                with monkeypatch.context() as m:
                    m.setattr(ops, "_on_card", lambda t: False)
                    want = torch.autograd.grad(fn(*ts), ts, ga)
            for g_, w_ in zip(got, want):
                assert g_.dtype == dtype
                _close(g_, w_, dtype)
    with pytest.raises(ValueError, match="bank"):
        ops.matmul_batched(a, w[:1])


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_moe_apply_on_card_matches_cpu(dev, arch):
    """The reduced MoE layer in f32 on 2 x 48 tokens (3 groups of 32; a
    direction common to every token crowds the same experts, so
    assignments drop): the card's routing (expert ids, positions, kept)
    equal to the CPU's, the output and aux within 1e-4."""
    from repro_torch.models import moe as MoE
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    p = MoE.moe_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 48, cfg.d_model, generator=g) \
        + torch.randn(cfg.d_model, generator=g)
    pc = tree_map(lambda t: t.to(dev), p)
    aux_cpu, aux_card = {}, {}
    want = MoE.moe_apply(p, x, cfg, aux=aux_cpu)
    got = MoE.moe_apply(pc, x.to(dev), cfg, aux=aux_card)
    r_cpu = MoE._route(p, x.reshape(3, 32, -1), cfg.moe)
    r_card = MoE._route(pc, x.to(dev).reshape(3, 32, -1), cfg.moe)
    for i in (3, 4, 5):
        assert torch.equal(r_card[i].cpu(), r_cpu[i]), i
    assert not r_cpu[5].all()
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for name in aux_cpu:
        torch.testing.assert_close(aux_card[name].cpu(), aux_cpu[name],
                                   atol=1e-6, rtol=1e-5)


def test_moe_engine_streams_equal_each_request_alone(dev):
    """Reduced mixtral (bf16) on 4 slots, its decode and remainder steps
    CUDA graphs: one batched dual GEMM and one batched GEMM a layer a
    step, and every stream equal to its request on a 1-slot engine (at 4
    slots no decode token is dropped, and every kernel row keeps its
    bits at any batch)."""
    cfg = get_config("mixtral-8x22b", reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), dev)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).numpy()
               for n in (40, 16, 37, 9)]
    eng = ServingEngine(cfg, params, max_slots=4, max_len=64, device=dev)
    reqs = [eng.submit(p, 6) for p in prompts]
    ops.reset_launch_counts()
    eng.run()
    n = ops.launch_counts()
    runs = eng.decode_steps + sum(len(p) % 8 for p in prompts) + len(prompts)
    assert n["gated_matmul_batched"] == n["matmul_batched"] \
        == cfg.n_layers * runs, (n, runs)
    one = ServingEngine(cfg, params, max_slots=1, max_len=64, device=dev)
    alone = [one.submit(p, 6) for p in prompts]
    one.run()
    assert [r.generated for r in reqs] == [r.generated for r in alone]


@pytest.mark.parametrize("window", [None, 100])
def test_flash_decode_at_a_group_of_7(dev, window):
    """Arctic's 56 query heads over 8 KV heads (a group of 7: passes of 4
    and 3), one-row, dense and a bf16 pool, against the plain version;
    each slot's row alone equal to its row in the batch, bit for bit."""
    b, tk, h, hkv, d = 4, 304, 56, 8, 128
    q = _randn(b, 1, h, d, dtype=torch.bfloat16, dev=dev, seed=0)
    k = _randn(b, tk, hkv, d, dtype=torch.bfloat16, dev=dev, seed=1)
    v = _randn(b, tk, hkv, d, dtype=torch.bfloat16, dev=dev, seed=2)
    pos = torch.tensor([-1, 0, 150, tk - 1], dtype=torch.int32, device=dev)
    got = ops.flash_decode(q, k, v, pos=pos, window=window)
    _close(got, ref.attention_fwd_ref(q, k, v, window=window, q_offset=pos),
           torch.bfloat16)
    kp, vp, table = _paged(k, v, 16, pos, seed=3)
    assert torch.equal(ops.flash_decode_paged(q, kp, vp, table, pos=pos,
                                              window=window), got)
    for i in range(1, b):
        alone = ops.flash_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                 pos=pos[i:i + 1], window=window)
        assert torch.equal(alone[0], got[i]), i


# ----------------------------------------------------------------------
# whisper-tiny (encdec): its shapes on the kernels, and its model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("tq", [1500, 128, 37])
def test_bf16_flash_attention_not_causal_at_whisper_shapes(dev, tq):
    """The encoder (Tq = Tk = 1500, 6 heads of 64, not causal) and
    cross-attention at prefill (Tq a prompt's bucket, 128, or ragged,
    against Tk = 1500 encoder keys) against the plain version."""
    q = _randn(1, tq, 6, 64, dtype=torch.bfloat16, dev=dev, seed=0)
    k = _randn(1, 1500, 6, 64, dtype=torch.bfloat16, dev=dev, seed=1)
    v = _randn(1, 1500, 6, 64, dtype=torch.bfloat16, dev=dev, seed=2)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=False)
    want_o, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=False)
    _close(o, want_o, torch.bfloat16)
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq", [1500, 448])
def test_flash_attention_bwd_not_causal_at_whisper_shapes(dev, dtype, tq):
    """The backward of training's encoder (Tq = Tk = 1500 = 23 x 64 + 28,
    a ragged key edge) and cross-attention (Tq = 448 decoder queries over
    1500 encoder keys), 6 heads of 64, not causal, against the plain
    version."""
    q = _randn(2, tq, 6, 64, dtype=dtype, dev=dev, seed=0)
    k = _randn(2, 1500, 6, 64, dtype=dtype, dev=dev, seed=1)
    v = _randn(2, 1500, 6, 64, dtype=dtype, dev=dev, seed=2)
    do = _randn(2, tq, 6, 64, dtype=dtype, dev=dev, seed=3)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=False)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=False)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=False)
    for x, y in zip(got, want):
        _close(x, y, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_over_the_encoder_keys(dev, dtype):
    """Cross-attention at a decode step: each slot's query over its 1500
    encoder keys (23 splits of 64 and one of 28) at pos = 1499, one slot
    idle (pos = -1: a zero row), against the plain version; a slot alone
    equal to its row in the batch, bit for bit."""
    b, tk, h, d = 4, 1500, 6, 64
    q = _randn(b, 1, h, d, dtype=dtype, dev=dev, seed=0)
    big_k = _randn(4, b, tk, h, d, dtype=dtype, dev=dev, seed=1)
    big_v = _randn(4, b, tk, h, d, dtype=dtype, dev=dev, seed=2)
    k, v = big_k[2], big_v[2]       # one layer's view of the cross cache
    pos = torch.tensor([tk - 1, -1, tk - 1, tk - 1], dtype=torch.int32,
                       device=dev)
    got = ops.flash_decode(q, k, v, pos=pos)
    _close(got, ref.attention_fwd_ref(q, k, v, q_offset=pos), dtype)
    assert not got[1].any(), "an idle slot must give zeros"
    for i in (0, 3):
        alone = ops.flash_decode(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                 pos=pos[i:i + 1])
        assert torch.equal(alone[0], got[i]), i


@pytest.mark.parametrize("mkn, epilogue", [
    ((4, 384, 1536), "bias_gelu"), ((1500, 384, 1536), "bias_gelu"),
    ((128, 384, 1536), "bias_gelu"), ((4, 1536, 384), "bias"),
    ((1500, 1536, 384), "bias")])
def test_whisper_mlp_gemms_match_plain(dev, mkn, epilogue):
    """whisper-tiny's MLP at decode (M = 4), a prompt bucket (128) and the
    encoder (1500 frames): w_in with the bias_gelu flush and w_out with
    the bias flush, on bf16 and on int8 weights, against the plain
    versions; a decode row's bits equal at M = 1."""
    m, k, n = mkn
    a = _randn(m, k, dtype=torch.bfloat16, dev=dev, seed=0)
    w = _randn(k, n, dtype=torch.float32, dev=dev, seed=1, scale=k ** -0.5)
    bias = _randn(n, dtype=torch.float32, dev=dev, seed=2, scale=0.1)
    wb = w.to(torch.bfloat16)
    got = ops.matmul(a, wb, epilogue=epilogue, bias=bias)
    _close(got, ref.fused_matmul_ref(a, wb, torch.bfloat16, epilogue,
                                     bias=bias), torch.bfloat16)
    wq, scale = precision.quantize_int8(w)
    got_q = ops.matmul_q(a, wq, scale, epilogue=epilogue, bias=bias)
    _close(got_q, ref.matmul_q_ref(a, wq, scale, torch.bfloat16, epilogue,
                                   bias=bias), torch.bfloat16)
    if m == 4:
        assert torch.equal(ops.matmul(a[1:2], wb, epilogue=epilogue,
                                      bias=bias), got[1:2])
        assert torch.equal(ops.matmul_q(a[1:2], wq, scale, epilogue=epilogue,
                                        bias=bias), got_q[1:2])


@pytest.mark.parametrize("d", [64, 384])
def test_layernorm_is_batch_invariant(dev, d):
    """Each row of 1, 2 or 3 normalises to the bits of the same row in a
    batch of 4 (whisper-tiny's d_model 384 and its reduced 64), as
    rmsnorm's rows do."""
    from repro_torch.models import layers as L
    p = {"scale": torch.rand(d, device=dev) + 0.5,
         "bias": torch.rand(d, device=dev) - 0.5}
    for seed in range(50):
        x = _randn(4, 1, d, dtype=torch.bfloat16, dev=dev, seed=seed)
        full = L.layernorm_apply(p, x)
        for rows in (slice(0, 1), slice(0, 2), slice(0, 3), slice(3, 4)):
            assert torch.equal(L.layernorm_apply(p, x[rows]), full[rows])


def test_encdec_prefill_and_decode_on_card_match_cpu(dev):
    """The reduced whisper in f32, random biases: a prefill of two
    prompts with their frames (the encoder and cross-attention through
    the non-causal flash kernel), two decode steps at a per-slot position
    vector with slot 1 idle (cross-attention through flash_decode) and
    one at an int position, on the card against the CPU: logits (the
    idle row's included: zeros from its attention on both) and every
    cache leaf."""
    cfg = dataclasses.replace(get_config("whisper-tiny", reduced=True),
                              dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    # the biases start at zeros: draw them, so that their flushes add
    params = tree_map(lambda t: t if t.any()
                      else torch.randn(t.shape, generator=g) * 0.1, params)
    tokens = torch.randint(0, cfg.vocab, (2, 11), generator=g)
    frames = torch.randn((2, cfg.enc_ctx, cfg.d_model), generator=g)
    out = {}
    for d in ("cpu", "cuda"):
        p = _to(params, d)
        cache = M.init_cache(cfg, 2, 16, d)
        lp, _ = M.prefill(cfg, p, {"tokens": tokens.to(d),
                                   "enc_frames": frames.to(d)}, cache)
        logs = [lp]
        for i in range(2):
            pos = torch.tensor([11 + i, -1], dtype=torch.int32, device=d)
            logs.append(M.decode_step(cfg, p, tokens[:, i:i + 1].to(d), pos,
                                      cache)[0])
        logs.append(M.decode_step(cfg, p, tokens[:, :1].to(d), 13, cache)[0])
        out[d] = [t.cpu() for t in logs] + [t.cpu() for t in leaves(cache)]
    for x, y in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-4)


# ----------------------------------------------------------------------
# tuning: every candidate instance gives the static plan's bits
# ----------------------------------------------------------------------

TUNE_M = [1, 4, 16, 17, 128, 2048]


def _tune_bank(dev, e, rows, cols, transposed, seed, scale=1.0):
    """An (e, rows, cols) bf16 bank: row-major, or the transpose view of a
    row-major (e, cols, rows) one."""
    if transposed:
        return _randn(e, cols, rows, dtype=torch.bfloat16, dev=dev,
                      seed=seed, scale=scale).transpose(1, 2)
    return _randn(e, rows, cols, dtype=torch.bfloat16, dev=dev, seed=seed,
                  scale=scale)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("m", TUNE_M)
def test_every_matmul_candidate_gives_the_static_plans_bits(dev, m, layout):
    """Each instance of the GEMM's space (`tuning.space`) at this shape
    and layout gives the static plan's output bit for bit, bf16 (with
    and without TMA, every epilogue kind, bf16 and f32 out) and f32, and
    so does the batched form over a bank of 3."""
    from repro_torch.kernels import matmul as tmm
    from repro_torch.tuning import space
    a_km, b_nk = layout
    for k, n in ((1024, 1536), (301, 259)):
        for dtype in (torch.bfloat16, torch.float32):
            a, b = _gemm_operands(dev, m, k, n, a_km, b_nk, dtype=dtype)
            cands = space.matmul_candidates(m, n, k, dtype, a_km=a_km,
                                            b_nk=b_nk)
            assert len(cands) >= 2, (m, k, n, cands)
            for ep in ("none", "bias_silu", "residual"):
                kw = _epilogue_kw(dev, ep, m, n, dtype)
                e = kw.get("bias", kw.get("residual"))
                for out_dtype in (torch.bfloat16, torch.float32):
                    want = ops.matmul(a, b, out_dtype=out_dtype,
                                      epilogue=ep, **kw)
                    for c in cands:
                        got = tmm.matmul_tiled(
                            a, b, out_dtype=out_dtype, epilogue=ep,
                            epilogue_operand=e, plan=c)
                        assert torch.equal(got, want), (k, n, dtype, ep,
                                                        out_dtype, c.name)
    k, n = 1024, 1536
    a = _tune_bank(dev, 3, m, k, a_km, seed=4)
    b = _tune_bank(dev, 3, k, n, b_nk, seed=5, scale=k ** -0.5)
    want = ops.matmul_batched(a, b)
    assert torch.equal(want[1], ops.matmul(a[1], b[1]))
    for c in space.matmul_candidates(m, n, k, a_km=a_km, b_nk=b_nk):
        assert torch.equal(tmm.matmul_batched_tiled(a, b, plan=c), want), \
            c.name


@pytest.mark.parametrize("m", TUNE_M)
def test_every_q_and_gated_candidate_gives_the_static_plans_bits(dev, m):
    """Each instance of the int8-weight GEMM's space (bf16 and f32 A, the
    residual epilogue, bf16 and f32 out) and of the dual GEMM's (TMA and
    not; the batched form over a bank of 3) gives the static plan's
    output bit for bit."""
    from repro_torch.kernels import matmul as tmm
    from repro_torch.tuning import space
    for k, n in ((1024, 3072), (2048, 1024)):
        w = _randn(k, n, dtype=torch.float32, dev=dev, seed=1,
                   scale=k ** -0.5)
        wq, scale = precision.quantize_int8(w)
        for dtype in (torch.bfloat16, torch.float32):
            a = _randn(m, k, dtype=dtype, dev=dev, seed=0)
            res = _randn(m, n, dtype=dtype, dev=dev, seed=2)
            for out_dtype in (torch.bfloat16, torch.float32):
                want = ops.matmul_q(a, wq, scale, out_dtype=out_dtype,
                                    epilogue="residual", residual=res)
                for c in space.matmul_candidates(m, n, k, dtype,
                                                 quant=True):
                    got = tmm.matmul_q_tiled(
                        a, wq, scale.reshape(n), out_dtype=out_dtype,
                        epilogue="residual", epilogue_operand=res, plan=c)
                    assert torch.equal(got, want), (k, n, dtype, c.name)
    for k, n, pad in ((1024, 3072, 0), (1024, 3072, 3), (77, 200, 0)):
        a = _randn(m, k + pad, dtype=torch.bfloat16, dev=dev, seed=0)[:, :k]
        wg = _randn(k, n, dtype=torch.bfloat16, dev=dev, seed=1,
                    scale=k ** -0.5)
        wu = _randn(k, n, dtype=torch.bfloat16, dev=dev, seed=2,
                    scale=k ** -0.5)
        want = ops.gated_matmul(a, wg, wu)
        for c in space.gated_matmul_candidates(m, n, k):
            got = tmm.gated_matmul_tiled(a, wg, wu, plan=c)
            assert torch.equal(got, want), (k, n, pad, c.name)
    k, n = 1024, 3072
    a = _tune_bank(dev, 3, m, k, False, seed=4)
    wg = _tune_bank(dev, 3, k, n, False, seed=5, scale=k ** -0.5)
    wu = _tune_bank(dev, 3, k, n, False, seed=6, scale=k ** -0.5)
    want = ops.gated_matmul_batched(a, wg, wu)
    for c in space.gated_matmul_candidates(m, n, k):
        assert torch.equal(tmm.gated_matmul_batched_tiled(a, wg, wu, plan=c),
                           want), c.name


def test_tune_matmul_and_gated_fill_a_temporary_cache(dev, tmp_path):
    """A sweep on the card's clock: the winner is in the cache and served
    while the cache is set; it is never slower than the static plan,
    which is timed in the same turns."""
    from repro_torch.kernels import matmul as tmm
    from repro_torch.tuning import autotuner, cache as tcache
    c = tcache.TuningCache(str(tmp_path / "tuning.json"))
    results = [
        autotuner.tune_matmul(4, 3072, 1024, cache=c, iters=5),
        autotuner.tune_matmul(2048, 1024, 3072, epilogue="residual",
                              cache=c, iters=5),
        autotuner.tune_matmul(4, 3072, 1024, quant="int8", cache=c,
                              iters=5),
        autotuner.tune_gated_matmul(2048, 3072, 1024, cache=c, iters=5),
        autotuner.tune_flash_decode(256, 128, cache=c, iters=5),
    ]
    for r in results:
        assert 0 < r.best_s <= r.baseline_s, r
        assert len(r.trials) >= 1 and c.entries[r.key]["time_us"] > 0
    assert tcache.TuningCache(c.path).load().entries == c.entries
    with tcache.tuned(c):
        assert tmm.tile_plan(4, 1024, 3072, False, False) is results[0].best
        assert tmm.gated_tile_plan(2048, 1024, 3072) is results[3].best
    assert tcache.tuned_cache() is None


def test_an_engine_under_tuned_plans_gives_the_static_engines_bits(
        dev, tmp_path, monkeypatch):
    """A cache whose winner is each space's last instance (a timer that
    favours it), set while an engine is built: its graphs capture those
    plans (the cache is hit, and most winners are not the static plan),
    a rebuild captures them again, its admission prefills (eager, run
    outside the setting) serve them too, and a decode step's logits and
    the streams equal a static engine's bit for bit."""
    from repro_torch.kernels import matmul as tmm
    from repro_torch.serving import engine as E
    from repro_torch.tuning import autotuner, cache as tcache
    monkeypatch.setattr(E, "_REBUILD_WARNED", True)
    eng, prompts = _serving(dev, "dense")
    cfg = eng.cfg
    c = tcache.TuningCache(str(tmp_path / "tuning.json"))
    last = lambda fns: [1.0 - i / 10 for i in range(len(fns))]
    buckets = sorted({len(p) - len(p) % 8 or len(p) for p in prompts} | {1})
    rep = autotuner.warm_start(cfg, 1, buckets, autotune=True, cache=c,
                               device=dev, timer=last)
    rep2 = autotuner.warm_start(cfg, 2, 1, autotune=True, cache=c,
                                decode_len=48, device=dev, timer=last)
    moved = [r for r in rep["results"] + rep2["results"]
             if r.best is not r.baseline]
    assert len(moved) >= 6, [r.key for r in moved]
    with tcache.tuned(c):
        tuned = ServingEngine(cfg, eng.params, max_slots=2, max_len=48,
                              device=dev)
    assert tuned.tuned_cache is c and tcache.tuned_cache() is None
    assert c.hits > 0
    hits = c.hits
    tuned._rebuild_steps(RuntimeError("a rebuild under the same setting"))
    assert c.hits > hits and tcache.tuned_cache() is None
    off, served = [], tmm._served

    def record(op, dtype, m, k, n, epilogue="none"):
        plan = served(op, dtype, m, k, n, epilogue)
        if plan is not None and plan != tmm.static_plan(op, dtype, m, k, n):
            off.append(m)
        return plan
    monkeypatch.setattr(tmm, "_served", record)
    logits, reqs = [], []
    for e in (eng, tuned):
        reqs.append([e.submit(p, 6) for p in prompts[:2]])
        e.step()
        e.step()
        e._step_tokens.copy_(e._tokens_h)
        e._step_pos.copy_(e._pos_h)
        logits.append(e._step().clone())
    assert any(m > 2 for m in off), off      # the prefills' rows
    assert torch.equal(logits[1], logits[0])
    for e in (eng, tuned):
        e.run()
    assert [r.generated for r in reqs[1]] == [r.generated for r in reqs[0]]
