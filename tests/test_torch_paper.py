"""The port's paper experiment (Table 2, Figs 8-9) on the CPU against the
JAX package, on the same numpy inputs: the naive GEMM, add, sub and axpy
dispatchers (their plain versions here) against the Pallas kernels in
interpret mode, the complex GEMM through real GEMMs, the GEMM
chokepoint's complex and float64 routes, the roofline and tile models,
the workload, and the Table-2 entry point and benchmark twins end to end.

Stated tolerances:
- naive GEMM, f32: atol = rtol = 1e-5 (the same sums in another order);
  bf16 outputs within one bf16 rounding (rtol 2^-7, atol 1e-2).
- add, sub and mul: bit for bit, f32 and bf16.
- axpy: bf16 bit for bit; f32 within u (|alpha x| + |port| + |jax|),
  u = 2^-24: XLA's CPU code fuses alpha * x + y into one FMA, while the
  port rounds the product first (as its kernel does, never contracting).
- complex GEMMs: atol = rtol = 1e-5 relative to the output's largest
  |value| (three or four real GEMMs, sums in another order).
- the models: equal to the JAX package's within 1e-12, relative.
- float64 (in a subprocess with x64, a process-wide switch): within
  1e-12.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocking as jblocking
from repro.core import gemm as jgemm
from repro.core import hw as jhw
from repro.core import intensity as jintensity
from repro.core import precision as jprecision
from repro.core.policy import Policy
from repro.configs.paper_gemm import CONFIG as JPAPER
from repro.kernels import elementwise as jew
from repro.kernels import ops as jops
from repro.kernels.matmul_naive import matmul_naive as jmatmul_naive
from repro_torch.configs.paper_gemm import CONFIG as PAPER
from repro_torch.core import blocking, gemm, hw, intensity, precision
from repro_torch.kernels import elementwise as kew
from repro_torch.kernels import matmul_naive as kmmn
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parents[1]
PALLAS = Policy(backend="pallas", interpret=True)
NAIVE = Policy(backend="naive", interpret=True)
U32 = 2.0 ** -24
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _close_naive(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-2,
                                   rtol=2 ** -7)


# ---------------------------------------------------------------- kernels

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mkn", [(16, 64, 128), (32, 40, 256)])
def test_matmul_naive_matches_pallas_kernel(dtype, mkn):
    """Shapes the Pallas kernel takes as they are (M, N multiples of its
    (16, 128) bf16 block)."""
    m, k, n = mkn
    rng = np.random.default_rng(0)
    ja, ta = _pair(rng, (m, k), dtype)
    jb, tb = _pair(rng, (k, n), dtype, k ** -0.5)
    got = ops.matmul_naive(ta, tb)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (m, n)
    _close_naive(got, jmatmul_naive(ja, jb, interpret=True), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mkn", [(100, 50, 130), (5, 37, 19), (1, 300, 1)])
def test_matmul_naive_ragged_matches_pallas_ops(dtype, mkn):
    """Ragged shapes: the JAX `naive` backend pads them to the kernel's
    block, the port's kernel masks its edges; the same function."""
    m, k, n = mkn
    rng = np.random.default_rng(1)
    ja, ta = _pair(rng, (m, k), dtype)
    jb, tb = _pair(rng, (k, n), dtype, k ** -0.5)
    want = jops.matmul(ja, jb, policy=NAIVE)
    _close_naive(ops.matmul_naive(ta, tb), want, dtype)
    _close_naive(ops.matmul_naive(ta, tb, out_dtype=torch.float32),
                 jops.matmul(ja, jb, policy=NAIVE, out_dtype=jnp.float32),
                 "float32")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("shape", [(256, 130), (512, 7)])
def test_binary_op_matches_pallas_kernel_bit_for_bit(dtype, op, shape):
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng, shape, dtype)
    jy, ty = _pair(rng, shape, dtype)
    want = jew.binary_op(jx, jy, op, interpret=True)
    got = ref.binary_ref(tx, ty, op)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(_np(got), _np(want))
    if op != "mul":             # ops.add / ops.sub: the dispatchers
        dispatched = getattr(ops, op)(tx, ty)
        jdispatched = getattr(jops, op)(jx, jy, policy=PALLAS)
        np.testing.assert_array_equal(_np(dispatched), _np(jdispatched))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("alpha", [0.7, 3.0, -1.3, "tensor"])
def test_axpy_matches_pallas_kernel(dtype, alpha):
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng, (256, 96), dtype)
    jy, ty = _pair(rng, (256, 96), dtype)
    if alpha == "tensor":
        jalpha, talpha = jnp.asarray(0.37, jnp.float32), torch.tensor([0.37])
    else:
        jalpha = talpha = alpha
    want = _np(jew.axpy(jalpha, jx, jy, interpret=True))
    got = ops.axpy(talpha, tx, ty)
    assert got.dtype == DTYPES[dtype][1]
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(got), want)
        return
    ax = np.float32(float(jnp.asarray(jalpha, jnp.float32))) * _np(tx)
    bound = U32 * (np.abs(ax) + np.abs(_np(got)) + np.abs(want))
    assert (np.abs(_np(got) - want) <= bound).all()
    # the plain version itself rounds twice: fl(fl(alpha x) + y)
    np.testing.assert_array_equal(_np(got), _np(ref.saxpy_ref(talpha, tx, ty)))


def test_ops_refuse_what_they_do_not_take():
    a = torch.ones(4, 6)
    with pytest.raises(ValueError):
        ops.matmul_naive(a, torch.ones(5, 2))
    with pytest.raises(ValueError):
        ops.add(a, torch.ones(6, 4))
    with pytest.raises(TypeError):
        ops.sub(a, a.double())
    with pytest.raises(ValueError):
        ops.axpy(2.0, a, torch.ones(4, 5))
    with pytest.raises(ValueError, match="op"):
        ref.binary_ref(a, a, "div")


@pytest.mark.parametrize("call", [
    lambda a: kmmn.matmul_naive(a, a.t().contiguous()),
    lambda a: kew.binary_op(a, a, "add"),
    lambda a: kew.axpy(2.0, a, a)])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A wrapper given a CPU tensor raises: the plain version is the
    dispatcher's choice, never the wrapper's fallback."""
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.ones(4, 4))


def test_launch_counters_do_not_move_on_cpu_for_the_paper_ops():
    ops.reset_launch_counts()
    a = torch.ones(3, 3)
    ops.matmul_naive(a, a)
    ops.add(a, a)
    ops.sub(a, a)
    ops.axpy(2.0, a, a)
    gemm.matmul(a.to(torch.complex64), a.to(torch.complex64))
    assert sum(ops.launch_counts().values()) == 0
    assert {"matmul_naive", "binary_op", "axpy"} <= set(ops.launch_counts())


def test_float64_matches_pallas_kernels_in_a_subprocess():
    """The paper's double column against the Pallas kernels in interpret
    mode with x64 on, a process-wide switch: the naive GEMM, add, sub,
    mul, axpy and the GEMM chokepoint's f64 route."""
    code = textwrap.dedent("""
        import sys; sys.path.insert(0, "src")
        import numpy as np, jax
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp, torch
        from repro.core import gemm as jgemm
        from repro.kernels import elementwise as jew
        from repro.kernels import ops as jops
        from repro_torch.core import gemm
        from repro_torch.kernels import ops, ref
        rng = np.random.default_rng(0)
        def err(t, j):
            assert t.dtype == torch.float64, t.dtype
            return float(np.abs(t.numpy() - np.asarray(j)).max())
        a, b = rng.normal(size=(100, 70)), rng.normal(size=(70, 130))
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        errs = [err(ops.matmul_naive(ta, tb),
                    jops.matmul(ja, jb, backend="naive_interpret")),
                err(gemm.matmul(ta, tb),
                    jgemm.matmul(ja, jb, backend="pallas_interpret"))]
        x, y = rng.normal(size=(256, 33)), rng.normal(size=(256, 33))
        jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x), torch.from_numpy(y)
        for op in ("add", "sub", "mul"):
            errs.append(err(ref.binary_ref(tx, ty, op),
                            jew.binary_op(jx, jy, op, interpret=True)))
        errs.append(err(ops.axpy(0.7, tx, ty), jew.axpy(0.7, jx, jy, interpret=True)))
        assert max(errs) < 1e-12, errs
        print("OK", errs)
    """)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-2000:]


# ------------------------------------------------------- complex and routes

def _complex_pair(rng, m, k, n):
    a = rng.normal(size=(m, k)) + 1j * rng.normal(size=(m, k))
    b = rng.normal(size=(k, n)) + 1j * rng.normal(size=(k, n))
    a, b = a.astype(np.complex64), b.astype(np.complex64)
    return (jnp.asarray(a), jnp.asarray(b)), (torch.from_numpy(a),
                                              torch.from_numpy(b))


def _close_complex(got, want):
    want = np.asarray(want)
    tol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=1e-5)


@pytest.mark.parametrize("algorithm", ["naive4", "gauss3"])
@pytest.mark.parametrize("kernel", ["tiled", "naive"])
def test_complex_matmul_matches_jax(algorithm, kernel):
    (ja, jb), (ta, tb) = _complex_pair(np.random.default_rng(4), 96, 64, 80)
    policy, real_mm = {"tiled": (PALLAS, ops.matmul),
                       "naive": (NAIVE, ops.matmul_naive)}[kernel]
    want = jprecision.complex_matmul(
        ja, jb, lambda x, y: jops.matmul(x, y, policy=policy), algorithm)
    got = precision.complex_matmul(ta, tb, real_mm, algorithm)
    assert got.dtype == torch.complex64
    _close_complex(got, want)


def test_complex_matmul_refuses_an_unknown_algorithm():
    with pytest.raises(ValueError, match="algorithm"):
        precision.complex_matmul(torch.ones(2, 2, dtype=torch.complex64),
                                 torch.ones(2, 2, dtype=torch.complex64),
                                 ops.matmul, "karatsuba")


def test_gemm_matmul_complex_matches_jax_and_differentiates():
    (ja, jb), (ta, tb) = _complex_pair(np.random.default_rng(5), 3 * 16, 24, 40)
    want = jgemm.matmul(ja, jb, policy=PALLAS)
    _close_complex(gemm.matmul(ta.reshape(3, 16, 24), tb).reshape(48, 40), want)
    # the gradient is PyTorch's (conjugate) convention, as torch.matmul's
    a, b = ta.clone().requires_grad_(), tb.clone().requires_grad_()
    gemm.matmul(a, b).abs().sum().backward()
    a2, b2 = ta.clone().requires_grad_(), tb.clone().requires_grad_()
    (a2 @ b2).abs().sum().backward()
    torch.testing.assert_close(a.grad, a2.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(b.grad, b2.grad, atol=1e-5, rtol=1e-5)


def test_dense_q_differentiates_on_cpu_as_jax_does():
    """The CPU path of `dense_q` is plain PyTorch: autograd gives the
    gradients of x, scale, b and residual that the JAX package's
    `_dense_q_vjp` gives."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    wq = rng.integers(-127, 128, size=(32, 24)).astype(np.int8)
    scale = rng.uniform(0.01, 0.02, size=(1, 24)).astype(np.float32)
    bias = rng.normal(size=(24,)).astype(np.float32)
    res = rng.normal(size=(2, 5, 24)).astype(np.float32)
    cot = rng.normal(size=(2, 5, 24)).astype(np.float32)

    def jloss(x_, s_, b_, r_):
        y = jgemm.dense_q(x_, jnp.asarray(wq), s_, b_, activation="silu",
                          residual=r_, policy=Policy())
        return jnp.sum(y * cot)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(v) for v in (x, scale, bias, res)))
    tx, ts, tb, tr = (torch.from_numpy(v).requires_grad_()
                      for v in (x, scale, bias, res))
    y = gemm.dense_q(tx, torch.from_numpy(wq), ts, tb, activation="silu",
                     residual=tr)
    (y * torch.from_numpy(cot)).sum().backward()
    for t, j in zip((tx, ts, tb, tr), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=1e-4, rtol=1e-4)


# ----------------------------------------------------------------- models

SHAPES = [(4096, 4096, 4096), (1024, 512, 2048), (100, 130, 50), (8, 8, 8),
          (2048, 4096, 256)]


PAPER_CHIPS = {"tesla-c2050": (jhw.TESLA_C2050, hw.TESLA_C2050),
               "tesla-c1060": (jhw.TESLA_C1060, hw.TESLA_C1060)}


def _same(a, b):
    if isinstance(a, str):
        assert a == b
    else:
        assert a == pytest.approx(b, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("chip", ["tesla-c2050", "tesla-c1060"])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_tile_and_time_models_equal_jax(chip, itemsize):
    jc, tc = PAPER_CHIPS[chip]
    for m, n, k in SHAPES:
        jcfg = jblocking.choose_block_config(m, n, k, itemsize, chip=jc)
        tcfg = blocking.choose_block_config(m, n, k, itemsize, chip=tc)
        assert (tcfg.bm, tcfg.bn, tcfg.bk) == (jcfg.bm, jcfg.bn, jcfg.bk)
        assert tcfg.smem_bytes(itemsize) == jcfg.vmem_bytes(itemsize)
        assert blocking.hbm_traffic_bytes(m, n, k, tcfg, itemsize) == \
            jblocking.hbm_traffic_bytes(m, n, k, jcfg, itemsize)
        assert blocking.naive_traffic_bytes(m, n, k, itemsize) == \
            jblocking.naive_traffic_bytes(m, n, k, itemsize)
        for tc_cfg, jc_cfg in ((tcfg, jcfg), (None, None)):
            got = blocking.gemm_time_model(m, n, k, itemsize, tc_cfg, chip=tc)
            want = jblocking.gemm_time_model(m, n, k, itemsize, jc_cfg, chip=jc)
            assert got.keys() == want.keys()
            for key in want:
                _same(got[key], want[key])


@pytest.mark.parametrize("chip", ["tesla-c2050", "tesla-c1060"])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_classifier_equals_jax(chip, itemsize):
    jc, tc = PAPER_CHIPS[chip]
    _same(intensity.machine_balance(tc, itemsize),
          jintensity.machine_balance(jc, itemsize))
    for m, n, k in SHAPES:
        for tp, jp in ((intensity.add_profile(m, n, itemsize),
                        jintensity.add_profile(m, n, itemsize)),
                       (intensity.matmul_profile(m, n, k, itemsize),
                        jintensity.matmul_profile(m, n, k, itemsize))):
            got = intensity.classify(tp, chip=tc, itemsize=itemsize)
            want = jintensity.classify(jp, chip=jc, itemsize=itemsize)
            assert got.keys() == want.keys()
            for key in want:
                _same(got[key], want[key])


def test_paper_chips_differ_from_jax_only_in_f64_rate_by_design():
    """The JAX model charges f32 / 10 for f64 on every chip (a rule for
    emulating f64 on a TPU); the port takes each card's own rate."""
    for name, f64 in (("tesla-c2050", 515e9), ("tesla-c1060", 78e9)):
        jc, tc = PAPER_CHIPS[name]
        assert tc.peak_flops(8) == f64
        assert jc.peak_flops(8) == jc.peak_flops_f32 / 10
        for field in ("name", "peak_flops_bf16", "peak_flops_f32", "hbm_bw",
                      "lane"):
            assert getattr(tc, field) == getattr(jc, field)
        assert tc.smem_bytes == jc.vmem_bytes
    assert hw.DEFAULT_CHIP is hw.H100
    assert blocking.KERNEL_TILE == blocking.BlockConfig(64, 64, 32)


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "bfloat16"])
def test_gemm_flops_equals_jax(dtype):
    for m, n, k in SHAPES:
        assert precision.gemm_flops(m, n, k, dtype) == \
            jprecision.gemm_flops(m, n, k, dtype)


def test_paper_workload_equals_jax_field_for_field():
    assert dataclasses.asdict(PAPER) == dataclasses.asdict(JPAPER)
    assert PAPER.reference_times == JPAPER.reference_times


def test_fingerprint_runs_without_a_card():
    fp = hw.fingerprint()
    assert fp.startswith("h100-sxm|") and f"torch-{torch.__version__}" in fp
    if not torch.cuda.is_available():
        assert "|cpu|" in fp


# ------------------------------------------------------------ entry points

def test_paper_entry_point_runs_on_cpu_and_models_as_the_example(capsys):
    from repro_torch.benchmarks import common
    from repro_torch.launch import paper
    rows = paper.main(["--device", "cpu", "--n", "128"])
    out = capsys.readouterr().out
    assert [(r["dtype"], r["route"]) for r in rows] == [
        (d, route) for d, routes in common.ROUTES.items() for route in routes]
    for r in rows:
        assert r["launches"] == {} and r["calls"] == 5      # plain versions
        assert r["max_abs_err"] <= r["tol"] and r["seconds"] > 0
        assert (r["route"], r["dtype"]) in common.LAUNCHES_PER_CALL
    assert "cpu (plain versions; not a device time)" in out
    assert "naive / tiled, float32" in out and "naive / tiled, complex64" in out
    # f64 has no tiled kernel: no ratio, no paper "shared" seconds beside it
    assert "naive / tiled, float64" not in out
    assert [r["paper_s"] for r in rows if r["dtype"] == "float64"] == \
        [3.13, None, None]
    # the modeled rows of examples/paper_reproduction.py, for the paper's
    # cards: (name, chip, shared, the paper's seconds)
    n = JPAPER.n
    example = [("tesla-c1060 shared", jhw.TESLA_C1060, True, 5.81),
               ("tesla-c2050 naive", jhw.TESLA_C2050, False, 2.49),
               ("tesla-c2050 shared", jhw.TESLA_C2050, True, 0.83)]
    got = common.model_rows()
    for (name, chip, shared, ref_s), r in zip(example, got):
        cfg = jblocking.choose_block_config(n, n, n, 4, chip=chip) \
            if shared else None
        want = jblocking.gemm_time_model(n, n, n, 4, cfg, chip=chip)
        assert (f"{r['chip']} {r['route']}", r["paper_s"]) == (name, ref_s)
        _same(r["seconds"], want["t_total"])
        _same(r["bytes"], want["bytes"])
        assert r["bound"] == want["bound"]
        shown = name + (f" ({cfg.bm}x{cfg.bn}x{cfg.bk} tile)" if cfg else "")
        assert f"{shown:38s}{r['seconds']:10.4f}{ref_s:10.2f}" in out
    assert [(r["chip"], r["route"], r["block"]) for r in got[3:]] == [
        ("h100-sxm", "naive", None), ("h100-sxm", "tiled", "64x64x32")]


@pytest.mark.parametrize("bench,names", [
    ("bench_matmul", ["matmul_cpu_plain_tiled_float32_32",
                      "matmul_cpu_plain_tiled_complex64_32",
                      "matmul_cpu_plain_f64_product_float64_32",
                      "matmul_cpu_plain_naive_float64_32",
                      "matmul_cpu_plain_torch_matmul_float32_32",
                      "matmul_model_tesla-c2050_shared_f32_4096",
                      "matmul_model_h100-sxm_tiled_f32_4096",
                      "matmul_model_h100-sxm_tiled_complex64_gauss3_4096"]),
    ("bench_shared_memory", ["shared_memory_model_tesla-c2050_naive_4096",
                             "shared_memory_model_h100-sxm_tiled_4096",
                             "shared_memory_cpu_plain_naive_float32_32",
                             "shared_memory_cpu_plain_tiled_complex64_32"]),
    ("bench_add", ["add_cpu_plain_32", "sub_cpu_plain_32", "axpy_cpu_plain_32",
                   "axpy_alpha_tensor_cpu_plain_32",
                   "add_unaligned_cpu_plain_32", "add_model_h100_32"])])
def test_benchmark_twins_run_on_cpu(capsys, bench, names):
    import importlib
    mod = importlib.import_module(f"repro_torch.benchmarks.{bench}")
    mod.main(["--device", "cpu", "--n", "32"])
    lines = capsys.readouterr().out.splitlines()
    emitted = {line.split(",")[0] for line in lines}
    assert set(names) <= emitted, emitted
    for line in lines:
        name, us, _ = line.split(",", 2)
        assert float(us) >= 0, line


def test_bench_add_counts_its_launches_per_call():
    from repro_torch.benchmarks import bench_add
    rows = bench_add.measure(16, torch.device("cpu"), iters=1, warmup=0)
    assert [r["case"] for r in rows] == list(bench_add.LAUNCHES_PER_CALL)
    assert all(r["launches"] == {} and r["calls"] == 2 for r in rows)


def test_paper_entry_points_raise_where_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from repro_torch.benchmarks import bench_add
    from repro_torch.launch import paper
    for main in (paper.main, bench_add.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--n", "8"])
