"""The port's CUDA kernels against their plain PyTorch versions, on the
card: ragged edges, both B layouts, int8 weights, strided cache views,
page pools (bf16, f32 and int8 pages, shuffled, -1 past each prefix),
GQA groups, idle and windowed slots, and whole decode steps, dense and
paged.

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
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M

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
    assert ops.launch_counts() == {"matmul": 1, "matmul_q": 1,
                                   "gated_matmul": 1, "flash_decode": 1,
                                   "flash_decode_paged": 1}


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


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
