"""The port's kernel dispatchers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels in interpret mode, on the same
numpy inputs.

Tolerance: float32 on both sides, atol = rtol = 1e-5. The two compute
the same function; the only difference is the order of the sums.
"""

import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import Policy
from repro.kernels import matmul as jmm
from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as kssd

TOL = dict(atol=1e-5, rtol=1e-5)
PALLAS = Policy(backend="pallas", interpret=True)
EPILOGUES = ("none", "bias", "bias_gelu", "bias_silu", "residual")


def _operands(rng, m, k, n):
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5
    bias = rng.standard_normal((n,)).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    return a, b, bias, res


def _port_matmul(a, b, epilogue, bias, res):
    t = torch.from_numpy
    kw = {}
    if epilogue == "residual":
        kw["residual"] = t(res)
    elif epilogue != "none":
        kw["bias"] = t(bias)
    return ops.matmul(t(a), t(b), epilogue=epilogue, **kw).numpy()


@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_matmul_matches_pallas_kernel(epilogue):
    rng = np.random.default_rng(0)
    a, b, bias, res = _operands(rng, 16, 64, 128)
    e = {"none": None, "residual": res}.get(epilogue, bias[None])
    want = jmm.matmul_tiled(jnp.asarray(a), jnp.asarray(b), bm=16, bn=128,
                            bk=32, interpret=True, epilogue=epilogue,
                            epilogue_operand=None if e is None else jnp.asarray(e))
    got = _port_matmul(a, b, epilogue, bias, res)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("mkn", [(5, 37, 19), (1, 64, 130), (33, 16, 7)])
def test_matmul_ragged_matches_pallas_ops(epilogue, mkn):
    rng = np.random.default_rng(1)
    a, b, bias, res = _operands(rng, *mkn)
    kw = {}
    if epilogue == "residual":
        kw["residual"] = jnp.asarray(res)
    elif epilogue != "none":
        kw["bias"] = jnp.asarray(bias)
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), policy=PALLAS,
                       epilogue=epilogue, **kw)
    got = _port_matmul(a, b, epilogue, bias, res)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_matmul_transposed_operand_matches():
    """The tied-embedding logits pass W^T as a transpose view."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    w = rng.standard_normal((40, 16)).astype(np.float32)
    want = jops.matmul(jnp.asarray(x), jnp.asarray(w).T, policy=PALLAS,
                       out_dtype=jnp.float32)
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(w).t(),
                     out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gated_matmul_matches_pallas_kernel():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((16, 64)).astype(np.float32)
    wg = rng.standard_normal((64, 128)).astype(np.float32) * 0.125
    wu = rng.standard_normal((64, 128)).astype(np.float32) * 0.125
    want = jmm.gated_matmul_tiled(jnp.asarray(a), jnp.asarray(wg),
                                  jnp.asarray(wu), bm=16, bn=128, bk=32,
                                  interpret=True)
    got = ops.gated_matmul(*(torch.from_numpy(x) for x in (a, wg, wu)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mkn", [(5, 37, 19), (4, 64, 96)])
def test_gated_matmul_ragged_matches_pallas_ops(mkn):
    m, k, n = mkn
    rng = np.random.default_rng(4)
    a = rng.standard_normal((m, k)).astype(np.float32)
    wg = rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5
    wu = rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5
    want = jops.gated_matmul(jnp.asarray(a), jnp.asarray(wg), jnp.asarray(wu),
                             policy=PALLAS)
    got = ops.gated_matmul(*(torch.from_numpy(x) for x in (a, wg, wu)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("pos", [[-1, 0, 30, 63], 40])
def test_flash_decode_matches_pallas_ops(window, pos):
    """GQA group 2; per-slot pos holding an idle slot, 0, a mid value and
    Tk - 1, or one scalar pos for every slot."""
    rng = np.random.default_rng(5)
    b, tk, h, hkv, d = 4, 64, 4, 2, 16
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, tk, hkv, d)).astype(np.float32)
    jpos = jnp.asarray(pos, jnp.int32) if isinstance(pos, list) else pos
    want = jops.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             pos=jpos, window=window, policy=PALLAS)
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) else pos
    got = ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), pos=tpos, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if isinstance(pos, list):
        assert not got[0].any(), "an idle slot (pos < 0) must give zeros"


def test_unknown_epilogue_raises():
    a = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="unknown epilogue"):
        ops.matmul(a, torch.zeros(3, 4), epilogue="bias_relu",
                   bias=torch.zeros(4))


@pytest.mark.parametrize("residual", [None, torch.zeros(2, 5),
                                      torch.zeros(4)])
def test_residual_of_wrong_shape_raises(residual):
    with pytest.raises(ValueError, match="residual"):
        ops.matmul(torch.zeros(2, 3), torch.zeros(3, 4), epilogue="residual",
                   residual=residual)


def test_operand_without_epilogue_raises():
    with pytest.raises(ValueError, match="need an epilogue"):
        ops.matmul(torch.zeros(2, 3), torch.zeros(3, 4),
                   bias=torch.zeros(4))


def test_launch_counters_do_not_move_on_cpu():
    """The CPU runs the plain versions: no kernel launch is counted."""
    ops.reset_launch_counts()
    ops.matmul(torch.ones(2, 3), torch.ones(3, 4))
    ops.gated_matmul(torch.ones(2, 3), torch.ones(3, 4), torch.ones(3, 4))
    ops.matmul_q(torch.ones(2, 3), torch.ones(3, 4, dtype=torch.int8),
                 torch.ones(4))
    ops.matmul_batched(torch.ones(2, 2, 3), torch.ones(2, 3, 4))
    ops.gated_matmul_batched(torch.ones(2, 2, 3), torch.ones(2, 3, 4),
                             torch.ones(2, 3, 4))
    ops.flash_decode_paged(torch.ones(1, 1, 2, 8), torch.ones(2, 4, 1, 8),
                           torch.ones(2, 4, 1, 8),
                           torch.tensor([[1, 0]], dtype=torch.int32), pos=5)
    ops.flash_decode(torch.ones(1, 3, 2, 8), torch.ones(1, 8, 1, 8),
                     torch.ones(1, 8, 1, 8), pos=2)
    kv = torch.ones(1, 4, 2, 8)
    o, lse = ops.flash_attention_fwd(kv, kv, kv)
    ops.flash_attention_bwd(kv, kv, kv, o, o, lse)
    ops.ssd(torch.ones(1, 4, 2, 3), -torch.ones(1, 4, 2),
            torch.ones(1, 4, 1, 5), torch.ones(1, 4, 1, 5), 2)
    ops.matmul_naive(torch.ones(2, 3), torch.ones(3, 4))
    ops.add(torch.ones(2, 3), torch.ones(2, 3))
    ops.axpy(2.0, torch.ones(2, 3), torch.ones(2, 3))
    assert ops.launch_counts() == {"matmul": 0, "matmul_q": 0,
                                   "gated_matmul": 0, "matmul_batched": 0,
                                   "gated_matmul_batched": 0,
                                   "flash_decode": 0,
                                   "flash_decode_paged": 0,
                                   "flash_decode_rows": 0,
                                   "flash_decode_paged_rows": 0,
                                   "flash_attention": 0,
                                   "flash_attention_bwd": 0, "ssd": 0,
                                   "matmul_naive": 0, "binary_op": 0,
                                   "axpy": 0}


def test_add_launch_counts_adds_by_kernel_and_refuses_unknown_names():
    """A CUDA graph's replay adds the launches its capture counted, and
    a capture takes its own out again (negative counts)."""
    ops.reset_launch_counts()
    ops.add_launch_counts({"matmul": 141, "flash_decode": 28})
    ops.add_launch_counts({"matmul": 141, "gated_matmul": 28})
    want = dict.fromkeys(ops.launch_counts(), 0)
    want.update(matmul=282, gated_matmul=28, flash_decode=28)
    assert ops.launch_counts() == want
    ops.add_launch_counts({k: -n for k, n in want.items()})
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(KeyError, match="flash_decode_ragged"):
        ops.add_launch_counts({"flash_decode_ragged": 1})
    assert set(ops.launch_counts().values()) == {0}


# (K, N, a_km, b_nk) of the main paths' bf16 GEMMs: qwen3-0.6b's QKV, O,
# gate/up and down projections and the tied-embedding logits (forward,
# and W^T in the input gradients), the weight gradients (A as [K, M] with
# K the tokens), mamba2-2.7b's in projections (z/x, then B/C/dt), its out
# projection and its head; then the int8 model's separate Q and K/V
# projections
MAIN_GEMMS = [(1024, 4096, False, False), (2048, 1024, False, False),
              (1024, 3072, False, False), (3072, 1024, False, False),
              (1024, 152064, False, True), (3072, 1024, False, True),
              (1024, 3072, False, True), (2048, 3072, True, False),
              (2048, 1024, True, False), (2560, 10240, False, False),
              (2560, 336, False, False), (5120, 2560, False, False),
              (2560, 50432, False, True), (1024, 2048, False, False),
              (1024, 1024, False, False)]


@pytest.mark.parametrize("k, n, a_km, b_nk", MAIN_GEMMS)
def test_tile_plan_k_order_does_not_depend_on_m(k, n, a_km, b_nk):
    """One output row has the same bits at every batch only if the bf16
    GEMM sums it in one order at every M: M may pick the row tile (and
    with it mma.sync or wgmma), never the k-step or a split of K. The
    same for the int8-weight and dual GEMMs (row-major operands only),
    whose k-order is the GEMM's."""
    ms = (1, 4, 8, 15, 16, 17, 64, 136, 512, 2048, 8192)
    kinds = {"matmul": {m: tmm.tile_plan(m, k, n, a_km, b_nk) for m in ms}}
    if not (a_km or b_nk):
        kinds["matmul_q"] = {m: tmm.q_tile_plan(m, k, n) for m in ms}
        kinds["gated_matmul"] = {m: tmm.gated_tile_plan(m, k, n) for m in ms}
    orders = {p.k_order for plans in kinds.values() for p in plans.values()}
    assert len(orders) == 1, kinds
    for plans in kinds.values():
        assert all(p.k_split == 1 for p in plans.values())
        # the two instructions whose k16 steps give the same bits on the
        # card (tests/test_torch_cuda.py::test_*_is_batch_invariant)
        assert {p.mma for p in plans.values()} <= {"mma.sync.m16n8k16",
                                                   "wgmma.m64n128k16",
                                                   "wgmma.m64n192k16",
                                                   "wgmma.m64n256k16"}
        assert {plans[m].bm for m in (1, 4, 16)} == {16}
        assert all(p.bm >= 64 for m, p in plans.items() if m > 16)


@pytest.mark.parametrize("k, n", sorted({(k, n) for k, n, _, _ in MAIN_GEMMS}
                                        | {(4096, 4096), (1000, 700)}))
def test_f32_tile_plan_k_order_does_not_depend_on_m(k, n):
    """The f32 GEMM (`csrc/matmul.cu`) sums each output one k at a time
    in ascending order in both of its tiles, with no split of K, so a row
    has the same bits at every M: M and N pick only the tile (the 64 x 64
    one for decode and few rows, the 128 x 128 one where its grid is
    wide enough, the paper's 4096^2 included)."""
    ms = (1, 4, 8, 16, 17, 64, 136, 512, 2048, 4096, 8192)
    plans = {m: tmm.f32_tile_plan(m, k, n) for m in ms}
    assert {p.k_order for p in plans.values()} == {(1, 1)}
    assert {p.mma for p in plans.values()} == {"fma"}
    assert {(p.kernel, p.bm, p.bn) for p in plans.values()} <= {
        (0, 64, 64), (1, 128, 128)}
    assert all(plans[m].bm == 64 for m in (1, 4, 8, 16, 17, 64))
    assert tmm.f32_tile_plan(4096, 4096, 4096).bm == 128


# (pos, window) of a decode slot: idle, the first key, a split's last and
# first key, mid-cache, the cache's last key, windows that start inside a
# split, a window shorter than a split
DECODE_SLOTS = [(-1, None), (0, None), (63, None), (64, None), (700, None),
                (2047, None), (700, 512), (2047, 512), (100, 7)]


def test_decode_split_matches_the_kernel_source():
    src = (Path(fa.__file__).parent / "csrc" / "flash_decode.cu").read_text()
    assert re.search(r"constexpr int SPLIT = (\d+);", src).group(1) \
        == str(fa.DECODE_SPLIT)


@pytest.mark.parametrize("pos, window", DECODE_SLOTS)
def test_decode_splits_depend_only_on_pos_and_window(pos, window):
    """A slot's decode row has the same bits at any batch and cache depth
    only if the kernel sums its keys in the same splits: they depend on
    the slot's pos, the window and DECODE_SPLIT, never on Tk (the plan
    takes no batch at all). They tile the slot's keys [lo, pos] in
    ascending order, every inner edge a multiple of DECODE_SPLIT, and
    each lies inside the scratch sized for Tk."""
    n = fa.DECODE_SPLIT
    depths = [tk for tk in (pos + 1, pos + 17, 2048, 4096) if tk > 0]
    plans = {tk: fa.decode_splits(pos, window, tk) for tk in depths}
    assert len({tuple(p) for p in plans.values()}) == 1, plans
    plan = plans[depths[0]]
    if pos < 0:
        assert plan == []
        return
    lo = max(0, pos - window + 1) if window else 0
    assert plan[0][0] == lo and plan[-1][1] == pos + 1
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    assert all(e % n == 0 for _, e in plan[:-1])
    assert all(0 < e - s <= n for s, e in plan)
    for tk in depths:
        splits = -(-tk // n)
        assert plan[-1][0] // n < splits
        assert fa.decode_scratch_floats(4, 16, 128, tk) == 4 * 16 * splits * 130


@pytest.mark.parametrize("pos, window", DECODE_SLOTS)
def test_decode_split_merge_is_the_softmax(pos, window):
    """The kernel's arithmetic in f32 on the CPU: each split's softmax
    partial (m, l, acc), merged in the plan's order, is the plain
    attention of the slot (zeros for a slot that sees no key)."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 1, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2048, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2048, 2, 16)).astype(np.float32))
    qs = q[0, 0].reshape(2, 2, 16) * 16 ** -0.5          # (Hkv, g, D)
    parts = []
    for s, e in fa.decode_splits(pos, window, 2048):
        sc = torch.einsum("kgd,tkd->kgt", qs, k[0, s:e])
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("kgt,tkd->kgd", p, v[0, s:e])))
    o = torch.zeros(2, 2, 16)
    if parts:
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp(m - mx) for m, _, _ in parts]
        o = sum(a * wi for (_, _, a), wi in zip(parts, w)) \
            / sum(l_ * wi for (_, l_, _), wi in zip(parts, w))
    want = ref.attention_fwd_ref(q, k, v, window=window, q_offset=pos)
    torch.testing.assert_close(o.reshape(1, 1, 4, 16), want, **TOL)


def test_ssd_launch_takes_the_cp_async_path_only_when_aligned(monkeypatch):
    """What the wrapper hands the kernel: the shape as given at B = 1,
    H = 80 and at B = 3, H = 8, the cp.async path only for 16-byte aligned
    operands, and one launch counted a call."""
    calls = []

    class Lib:
        @staticmethod
        def repro_ssd_intra_chunk(*args):
            calls.append(dict(b=args[6], h=args[8], q=args[12],
                              vec=args[25], bf16=args[26]))
            return 0

    monkeypatch.setattr(kssd, "_check_cuda", lambda *ts: None)
    monkeypatch.setattr(kssd._build, "load", lambda name, sig: Lib)
    monkeypatch.setattr(kssd._build, "stream_ptr", lambda dev: None)
    monkeypatch.setitem(kssd.LAUNCHES, "ssd", 0)
    for bsz, h in ((1, 80), (3, 8)):
        x = torch.zeros(bsz, 512, h, 64)
        bc = torch.zeros(bsz, 512, 1, 128)
        kssd.ssd_intra_chunk(x, torch.zeros(bsz, 512, h), bc, bc, 256)
    xw = torch.zeros(1, 512, 8, 65)
    kssd.ssd_intra_chunk(xw[..., 1:], torch.zeros(1, 512, 8), bc[:1],
                         bc[:1], 256)
    assert kssd.LAUNCHES["ssd"] == 3
    assert [(c["b"], c["h"], c["q"], c["vec"], c["bf16"]) for c in calls] \
        == [(1, 80, 256, 1, 0), (3, 8, 256, 1, 0), (1, 8, 256, 0, 0)]


def test_ssd_signature_matches_the_c_entry_point():
    """The wrapper's ctypes signature has the C entry point's parameters,
    pointers, ints and long longs in its order: the source cannot be
    compiled here, so a mismatch would show only on the card."""
    src = (Path(kssd.__file__).parent / "csrc" / "ssd.cu").read_text()
    params = re.search(r'extern "C" int repro_ssd_intra_chunk\((.*?)\)',
                       src, re.S).group(1).split(",")
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    want = [ctypes.c_void_p if "*" in q
            else kinds[q.strip().rsplit(" ", 1)[0]] for q in params]
    assert kssd._SIGNATURES["repro_ssd_intra_chunk"] == want
