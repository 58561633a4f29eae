"""The port's CUDA kernels against their plain PyTorch versions, on the
card: ragged edges, both A and B layouts, int8 weights, strided cache
views, page pools (bf16, f32 and int8 pages, shuffled, -1 past each
prefix), GQA groups, idle and windowed slots, the training attention's
forward and backward (ragged T, windows, rows that see no key), the SSD
intra-chunk kernel (ragged chunks, groups read through strides, bf16
inputs, a carried state, strong decays), the paper's naive GEMM and
elementwise kernels (add, sub, mul and axpy bit for bit), whole decode
steps, dense, paged and Mamba-2, and a whole train step.

Marked `cuda`; each test skips where there is no CUDA device. On the
card: `PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`.
Tolerance: f32 atol = rtol = 1e-4 (sums in another order); bf16 outputs
may differ by one rounding of the f32 result (rtol 2^-7) plus atol 1e-3.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import precision
from repro_torch.core.tree import leaves
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("window", [None, 7, 128])
def test_flash_attention_bwd_kernel_matches_plain(dev, dtype, shape, window):
    q, k, v = _attn_inputs(dev, dtype, shape)
    o, lse = ref.flash_attention_fwd_ref(q, k, v, causal=True, window=window)
    do = _randn(*q.shape, dtype=dtype, dev=dev, seed=3)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                  window=window)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=True,
                                       window=window)
    for x, y in zip(got, want):
        _close(x, y, dtype)


def test_flash_attention_bwd_is_deterministic(dev):
    q, k, v = _attn_inputs(dev, torch.bfloat16, (2, 200, 4, 1, 128))
    o, lse = ops.flash_attention_fwd(q, k, v, causal=True)
    do = _randn(*q.shape, dtype=torch.bfloat16, dev=dev, seed=3)
    first = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mkn", [(5, 37, 19), (4, 1024, 3072), (70, 100, 65)])
def test_gated_matmul_kernel_matches_plain(dev, dtype, mkn):
    m, k, n = mkn
    a = _randn(m, k, dtype=dtype, dev=dev, seed=0)
    wg = _randn(k, n, dtype=dtype, dev=dev, seed=1, scale=k ** -0.5)
    wu = _randn(k, n, dtype=dtype, dev=dev, seed=2, scale=k ** -0.5)
    _close(ops.gated_matmul(a, wg, wu), ref.gated_matmul_ref(a, wg, wu), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 37, 4, 4, 16), (4, 100, 8, 2, 64),
                                   (2, 300, 16, 8, 128)])
@pytest.mark.parametrize("window", [None, 7])
def test_flash_decode_kernel_matches_plain(dev, dtype, shape, window):
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
                                 (129, 33, 257)])
def test_matmul_q_kernel_matches_plain(dev, dtype, epilogue, mkn):
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
        got = ops.matmul_q(a, wq, scale, out_dtype=out_dtype,
                           epilogue=epilogue, **kw)
        want = ref.matmul_q_ref(a, wq, scale, out_dtype, epilogue,
                                kw.get("bias"), kw.get("residual"))
        _close(got, want, out_dtype if out_dtype == dtype else torch.float32)


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


def test_each_wrapper_counts_one_launch(dev):
    a = torch.ones(3, 8, device=dev)
    w = torch.ones(8, 5, device=dev)
    ops.reset_launch_counts()
    ops.matmul(a, w)
    ops.matmul_q(a, w.to(torch.int8), torch.ones(5, device=dev))
    ops.gated_matmul(a, w, w)
    q = torch.ones(1, 1, 2, 16, device=dev)
    kv = torch.ones(1, 4, 2, 16, device=dev)
    ops.flash_decode(q, kv, kv, pos=2)
    table = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    ops.flash_decode_paged(q, kv, kv, table, pos=2)
    o, lse = ops.flash_attention_fwd(kv, kv, kv)
    ops.flash_attention_bwd(kv, kv, kv, o, o, lse)
    ops.ssd(torch.ones(1, 4, 2, 3, device=dev), -torch.ones(1, 4, 2, device=dev),
            torch.ones(1, 4, 1, 5, device=dev), torch.ones(1, 4, 1, 5, device=dev), 2)
    ops.matmul_naive(a, w)
    ops.add(a, a)
    ops.axpy(2.0, a, a)
    assert ops.launch_counts() == {"matmul": 1, "matmul_q": 1,
                                   "gated_matmul": 1, "flash_decode": 1,
                                   "flash_decode_paged": 1,
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


def test_ssd_on_card_refuses_a_gradient(dev):
    from repro_torch.core import ssd as core_ssd
    x, a, bm, cm = _ssd_inputs(dev, SSD_SHAPES[-1])
    with pytest.raises(NotImplementedError, match="training"):
        core_ssd.ssd(x.requires_grad_(), a, bm, cm, 16)


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


def test_dense_q_on_card_refuses_a_gradient(dev):
    from repro_torch.core import gemm
    x = torch.ones(2, 8, device=dev)
    wq, scale = precision.quantize_int8(torch.ones(8, 4, device=dev))
    assert gemm.dense_q(x, wq, scale).shape == (2, 4)
    with torch.no_grad():
        gemm.dense_q(x.clone().requires_grad_(), wq, scale)
    for kw in ({"x": x.clone().requires_grad_()},
               {"scale": scale.clone().requires_grad_()},
               {"b": torch.zeros(4, device=dev, requires_grad=True)},
               {"residual": torch.zeros(2, 4, device=dev, requires_grad=True)}):
        args = {"x": x, "scale": scale, **kw}
        with pytest.raises(NotImplementedError, match="forward only"):
            gemm.dense_q(args.pop("x"), wq, args.pop("scale"), **args)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
