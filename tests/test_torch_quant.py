"""The port's int8 path against the JAX package's: the quantizers, the
int8-weight GEMM's plain version against the Pallas kernel in interpret
mode, the quantized dense layer, a decode step on quantized params, and
the serving engine with int8 weights over a paged KV pool; and int8
weights on the ssm (mamba2) and hybrid (zamba2, at 4 layers with a
random lora_b) families: the quantized param trees, prefill and decode
steps, and the ssm engine's streams (`test_torch_hybrid.py` holds the
hybrid engine's), against the JAX package under its default policy.

Both sides run in float32 on the same numpy inputs; the JAX side under
`Policy(backend="pallas", interpret=True)`. Tolerances: the quantizers
bit for bit (the same f32 operations); the GEMM atol = rtol = 1e-5 (the
same function, sums in another order); logits atol = 1e-4; the engine's
greedy streams token for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import gemm as jgemm
from repro.core import precision as jprec
from repro.core.policy import Policy
from repro.kernels import matmul as jmm
from repro.kernels import ops as jops
from repro.models import model as JM
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import gemm, precision
from repro_torch.core.tree import leaves
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from repro_torch.serving import ServingEngine

TOL = dict(atol=1e-5, rtol=1e-5)
ATOL = 1e-4
PALLAS = Policy(backend="pallas", interpret=True)
EPILOGUES = ("none", "bias", "bias_gelu", "bias_silu", "residual")


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params)


def _equal(got: torch.Tensor, want) -> None:
    want = np.array(want)
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------------
# quantizers
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((48, 24), -2), ((3, 16, 8), -2),
                                        ((5, 2, 3, 16), -1)])
def test_quantize_int8_bit_identical(shape, axis):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3, shape[-1])) \
        .astype(np.float32)
    w[..., 1] = 0.0                           # a zero channel: scale 1
    w.reshape(-1)[::7] *= 1.5                 # ties and extremes
    q, s = precision.quantize_int8(torch.from_numpy(w), axis=axis)
    jq, js = jprec.quantize_int8(jnp.asarray(w), axis=axis)
    _equal(q, jq)
    _equal(s, js)
    _equal(precision.dequantize(q, s), jprec.dequantize(jq, js))
    _equal(ref.dequantize_ref(q, s), jprec.dequantize(jq, js))
    if axis == -1:
        q, s = precision.quantize_kv(torch.from_numpy(w))
        jq, js = jprec.quantize_kv(jnp.asarray(w))
        _equal(q, jq)
        _equal(s, js)


def test_quant_spec_refuses_unknown_mode():
    assert precision.QUANT_MODES == jprec.QUANT_MODES
    with pytest.raises(ValueError, match="quantization mode"):
        precision.QuantSpec(mode="int4")


def test_quantize_params_matches_reference(model):
    mine = M.quantize_params(model["params"])
    ref = JM.quantize_params(model["jparams"])
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    n_int8 = 0
    for path, leaf in flat:
        node = mine
        for key in path:
            node = node[key.key]
        _equal(node, leaf)
        n_int8 += node.dtype == torch.int8
    # 7 dense weights a layer (q, k, v, o, gate, up, down); not the embed
    assert n_int8 == 7 and mine["embed"]["w"].dtype == torch.float32
    assert mine["layers"]["mlp"]["w_down"]["w_scale"].shape == (2, 1, 64)


# ----------------------------------------------------------------------
# the int8-weight GEMM
# ----------------------------------------------------------------------

def _operands(rng, m, k, n):
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) * k ** -0.5
    wq, scale = (np.asarray(x) for x in jprec.quantize_int8(jnp.asarray(w)))
    bias = rng.standard_normal((n,)).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    return a, wq, scale, bias, res


def _port_matmul_q(a, wq, scale, epilogue, bias, res):
    t = torch.from_numpy
    kw = {}
    if epilogue == "residual":
        kw["residual"] = t(res)
    elif epilogue != "none":
        kw["bias"] = t(bias)
    return ops.matmul_q(t(a), t(wq), t(scale), epilogue=epilogue, **kw).numpy()


@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_matmul_q_matches_pallas_kernel(epilogue):
    rng = np.random.default_rng(0)
    a, wq, scale, bias, res = _operands(rng, 16, 64, 128)
    e = {"none": None, "residual": res}.get(epilogue, bias[None])
    want = jmm.matmul_q_tiled(
        jnp.asarray(a), jnp.asarray(wq), jnp.asarray(scale), bm=16, bn=128,
        bk=32, interpret=True, epilogue=epilogue,
        epilogue_operand=None if e is None else jnp.asarray(e))
    got = _port_matmul_q(a, wq, scale, epilogue, bias, res)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("epilogue,mkn",
                         [(ep, (5, 37, 19)) for ep in EPILOGUES]
                         + [("none", (1, 64, 130))])
def test_matmul_q_ragged_matches_pallas_ops(epilogue, mkn):
    rng = np.random.default_rng(1)
    a, wq, scale, bias, res = _operands(rng, *mkn)
    kw = {}
    if epilogue == "residual":
        kw["residual"] = jnp.asarray(res)
    elif epilogue != "none":
        kw["bias"] = jnp.asarray(bias)
    want = jops.matmul_q(jnp.asarray(a), jnp.asarray(wq),
                         jnp.asarray(scale.reshape(-1)), policy=PALLAS,
                         epilogue=epilogue, **kw)
    got = _port_matmul_q(a, wq, scale.reshape(-1), epilogue, bias, res)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_matmul_q_refuses_bad_operands():
    a = torch.ones(2, 4)
    wq = torch.ones(4, 3, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        ops.matmul_q(a, wq.float(), torch.ones(3))
    with pytest.raises(ValueError, match="scale shape"):
        ops.matmul_q(a, wq, torch.ones(4))
    with pytest.raises(ValueError, match="scale shape"):
        ops.matmul_q(a, wq, torch.ones(2, 3))
    with pytest.raises(ValueError, match="floating"):
        ops.matmul_q(a, wq, torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="shapes"):
        ops.matmul_q(torch.ones(2, 5), wq, torch.ones(3))


@pytest.mark.parametrize("case", ["bias_silu", "residual", "broadcast",
                                  "plain"])
def test_dense_q_matches_reference(case):
    """The fusion rule of `_dense_q_2d`, on (batch, seq, K) activations:
    bias and activation ride the flush, an (m, n) residual rides it
    alone, a broadcast residual is added after."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    _, wq, scale, bias, _ = _operands(rng, 1, 32, 24)
    res = {"residual": rng.standard_normal((2, 3, 24)),
           "broadcast": rng.standard_normal((24,))}.get(case)
    kw = dict(activation="silu") if case == "bias_silu" else {}
    jb = jnp.asarray(bias) if case == "bias_silu" else None
    jr = None if res is None else jnp.asarray(res.astype(np.float32))
    want = jgemm.dense_q(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale),
                         jb, residual=jr, policy=PALLAS, **kw)
    t = torch.from_numpy
    got = gemm.dense_q(t(x), t(wq), t(scale), None if jb is None else t(bias),
                       residual=None if res is None else t(res.astype(np.float32)),
                       **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------------------
# the model and the engine on quantized params
# ----------------------------------------------------------------------

def test_quantized_decode_step_matches_reference(model):
    """A per-slot decode step on quantized params over a dense cache of
    random rows (slot 1 idle: its logits are garbage and not compared)."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    rng = np.random.default_rng(3)
    shape = (cfg.n_layers, 2, 16, cfg.n_kv_heads, cfg.resolved_head_dim)
    rows = {n: rng.standard_normal(shape).astype(np.float32)
            for n in ("k", "v")}
    tok = np.array([[3], [7]], np.int32)
    pos = np.array([8, -1], np.int32)
    jq = JM.quantize_params(model["jparams"])
    with PALLAS.scope():
        jlog, _ = JM.decode_step(jcfg, jq, jnp.asarray(tok), jnp.asarray(pos),
                                 {n: jnp.asarray(x) for n, x in rows.items()})
    q = M.quantize_params(model["params"])
    log, _ = M.decode_step(cfg, q, torch.from_numpy(tok).long(),
                           torch.from_numpy(pos),
                           {n: torch.from_numpy(x) for n, x in rows.items()})
    np.testing.assert_allclose(log[:1].numpy(), np.asarray(jlog)[:1],
                               atol=ATOL, rtol=0)


def test_engine_int8_weights_paged_streams_match_jax_engine(model):
    """quant="int8" quantizes the f32 weights once at construction; with
    a paged KV pool the greedy streams equal the JAX engine's, over 4
    prompts on 2 slots (13 runs prefill-remainder steps)."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (8, 13, 20, 5)]
    gens = [3, 4, 2, 3]

    def run(engine):
        reqs = [engine.submit(p, g) for p, g in zip(prompts, gens)]
        assert engine.run()["n_finished"] == len(reqs)
        return [r.generated for r in reqs]

    want = run(JaxEngine(jcfg, model["jparams"], max_slots=2, max_len=32,
                         page_size=8,
                         policy=Policy(backend="pallas", interpret=True,
                                       kv_layout="paged", quant="int8")))
    eng = ServingEngine(cfg, model["params"], max_slots=2, max_len=32,
                        device="cpu", kv_layout="paged", quant="int8",
                        page_size=8)
    assert eng.params["layers"]["attn"]["wq"]["w_q"].dtype == torch.int8
    assert eng.params["layers"]["attn"]["wq"]["w_scale"].dtype == torch.float32
    assert run(eng) == want


# ----------------------------------------------------------------------
# int8 weights on the ssm and hybrid families
# ----------------------------------------------------------------------

RECURRENT = {"mamba2-2.7b": {}, "zamba2-1.2b": dict(n_layers=4)}


@pytest.fixture(scope="module", params=list(RECURRENT))
def recurrent(request):
    """float32 reduced mamba2, and zamba2 at 4 layers (two segments) with
    a seeded random lora_b, on the JAX package's weights."""
    arch = request.param
    kw = dict(RECURRENT[arch], dtype="float32")
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True), **kw)
    cfg = dataclasses.replace(get_config(arch, reduced=True), **kw)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    if cfg.family == "hybrid":
        # lora_b starts at zeros: draw it, so the LoRA path computes
        lb = jparams["hybrid"]["lora_b"]
        jparams["hybrid"]["lora_b"] = jnp.asarray(
            np.random.default_rng(7).normal(size=lb.shape)
            * lb.shape[1] ** -0.5, lb.dtype)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jparams=jparams,
                params=params)


def test_quantize_params_of_recurrent_families_matches_reference(recurrent):
    """The same keys and shapes as the reference's walk, int8 values and
    scales bit for bit: mamba2's 3D stacks and lm_head quantized; zamba2's
    4-D Mamba stacks and LoRA pairs left float (the walk quantizes 2D and
    3D weights only), its shared block, in_proj and lm_head quantized."""
    mine = M.quantize_params(recurrent["params"])
    ref = JM.quantize_params(recurrent["jparams"])
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat) == len(leaves(mine))
    n_int8 = 0
    for path, leaf in flat:
        node = mine
        for key in path:
            node = node[key.key]
        _equal(node, leaf)
        n_int8 += node.dtype == torch.int8
    assert mine["lm_head"]["w_q"].dtype == torch.int8
    if recurrent["cfg"].family == "ssm":
        # in_proj, in_proj_bc, out_proj (stacked), and lm_head
        assert n_int8 == 4
        assert mine["layers"]["mamba"]["in_proj"]["w_scale"].shape \
            == (2, 1, mine["layers"]["mamba"]["in_proj"]["w_q"].shape[-1])
    else:
        hp = mine["hybrid"]
        # in_proj, q, k, v, o, gate, up, down, and lm_head
        assert n_int8 == 9
        assert hp["mamba"]["mamba"]["in_proj"]["w"].dim() == 4
        assert hp["mamba"]["mamba"]["in_proj"]["w"].dtype == torch.float32
        assert hp["lora_a"].dtype == hp["lora_b"].dtype == torch.float32


def test_quantized_recurrent_prefill_and_decode_match_reference(recurrent):
    """prefill of 20 tokens and 2 decode steps at a per-slot position
    vector, on quantized params: logits (atol 1e-4) and every cache leaf
    (atol = rtol = 1e-4)."""
    cfg, jcfg = recurrent["cfg"], recurrent["jcfg"]
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 20)).astype(np.int32)
    jq = JM.quantize_params(recurrent["jparams"])
    jlog, jc = JM.prefill(jcfg, jq, {"tokens": jnp.asarray(tokens)},
                          JM.init_cache(jcfg, 2, 32))
    jlogs = [jlog]
    for i in range(2):
        jl, jc = JM.decode_step(jcfg, jq, jnp.asarray(tokens[:, i:i + 1]),
                                jnp.full((2,), 20 + i, jnp.int32), jc)
        jlogs.append(jl)
    q = M.quantize_params(recurrent["params"])
    cache = M.init_cache(cfg, 2, 32, "cpu")
    log, _ = M.prefill(cfg, q, {"tokens": torch.from_numpy(tokens).long()},
                       cache)
    logs = [log]
    for i in range(2):
        log, _ = M.decode_step(cfg, q, torch.from_numpy(tokens[:, i:i + 1])
                               .long(), torch.full((2,), 20 + i,
                                                   dtype=torch.int32), cache)
        logs.append(log)
    for got, want in zip(logs, jlogs):
        np.testing.assert_allclose(got[..., :cfg.vocab].numpy(),
                                   np.asarray(want)[..., :cfg.vocab],
                                   atol=ATOL, rtol=0)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        node = cache
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(leaf),
                                   atol=ATOL, rtol=ATOL)


def test_engine_int8_weights_ssm_streams_match_jax_engine():
    """mamba2 with quant="int8" on both engines: 4 prompts on 2 slots (13
    and 21 run remainder steps), the greedy streams token for token."""
    arch = "mamba2-2.7b"
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (8, 13, 21, 5)]
    gens = [3, 4, 9, 2]

    def run(engine):
        reqs = [engine.submit(p, g) for p, g in zip(prompts, gens)]
        assert engine.run()["n_finished"] == len(reqs)
        return [r.generated for r in reqs]

    want = run(JaxEngine(jcfg, jparams, max_slots=2, max_len=48,
                         policy=Policy(quant="int8")))
    eng = ServingEngine(cfg, params, max_slots=2, max_len=48, device="cpu",
                        quant="int8")
    assert eng.params["layers"]["mamba"]["out_proj"]["w_q"].dtype == torch.int8
    assert run(eng) == want
