"""The port's CUDA kernels against their plain PyTorch versions, on the
card: ragged edges, both B layouts, strided cache views, GQA groups,
idle and windowed slots, and a whole decode step.

Marked `cuda`; each test skips where there is no CUDA device. On the
card: `PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`.
Tolerance: f32 atol = rtol = 1e-4 (sums in another order); bf16 outputs
may differ by one rounding of the f32 result (rtol 2^-7) plus atol 1e-3.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
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


def test_each_wrapper_counts_one_launch(dev):
    a = torch.ones(3, 8, device=dev)
    w = torch.ones(8, 5, device=dev)
    ops.reset_launch_counts()
    ops.matmul(a, w)
    ops.gated_matmul(a, w, w)
    q = torch.ones(1, 1, 2, 16, device=dev)
    kv = torch.ones(1, 4, 2, 16, device=dev)
    ops.flash_decode(q, kv, kv, pos=2)
    assert ops.launch_counts() == {"matmul": 1, "gated_matmul": 1,
                                   "flash_decode": 1}


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


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
