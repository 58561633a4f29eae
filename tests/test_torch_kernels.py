"""The port's kernel dispatchers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels in interpret mode, on the same
numpy inputs.

Tolerance: float32 on both sides, atol = rtol = 1e-5. The two compute
the same function; the only difference is the order of the sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import Policy
from repro.kernels import matmul as jmm
from repro.kernels import ops as jops
from repro_torch.kernels import ops

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
    assert ops.launch_counts() == {"matmul": 0, "gated_matmul": 0,
                                   "flash_decode": 0}
