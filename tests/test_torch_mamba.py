"""The port's mamba2 (reduced) against the JAX package's: the config,
the bridged params, the Mamba-2 block (prefill with its returned state,
and the one-token step), the stack, prefill / decode_step, and the
serving engine's greedy streams; on the same weights (the JAX params,
bridged leaf for leaf) and the same numpy inputs. The JAX side runs
jitted under its default policy, so its SSD scan is `ssd_chunked`, the
plain reference of the Pallas kernel (`test_torch_ssd.py` holds the port's
scan against the kernel in interpret mode too).

Stated tolerances: float32 atol = rtol = 1e-5 for a block, 1e-4 for the
model's logits and states (as the dense model's tests); the engine's
streams token for token, over one round of requests and over two (the
second on the first's sub-state and step inputs). bfloat16: atol =
rtol = 2^-5 (four bf16 roundings at 1.0) for a block, because XLA's bf16
elementwise ops (silu, the gated norm's input) round at other places
than PyTorch's (the projections and the prefill conv agree bit for
bit); 2^-4 for the model, where those roundings compound over the layers
and into the logits' sums.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.serving import ServingEngine

ARCH = "mamba2-2.7b"
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2 ** -5, rtol=2 ** -5)}
MODEL_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
             "bfloat16": dict(atol=2 ** -4, rtol=2 ** -4)}


def _jax_params(jcfg):
    return jax.jit(lambda k: JM.init_params(jcfg, k))(jax.random.PRNGKey(0))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def setup(request):
    dt = request.param
    jcfg = dataclasses.replace(jax_get_config(ARCH, reduced=True), dtype=dt)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), dtype=dt)
    jparams = _jax_params(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return dict(dt=dt, jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                jdtype=jnp.dtype(dt), dtype=getattr(torch, dt))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _layer(tree, i=0):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def test_config_matches_reference():
    for reduced in (False, True):
        a = dataclasses.asdict(get_config(ARCH, reduced=reduced))
        b = dataclasses.asdict(jax_get_config(ARCH, reduced=reduced))
        assert a == {k: v for k, v in b.items() if k in a}
        assert get_config(ARCH, reduced=reduced).is_attention_free
    cfg = get_config(ARCH)
    assert cfg.padded_vocab == 50432 and not cfg.tie_embeddings
    assert (cfg.ssm.expand * cfg.d_model) // cfg.ssm.head_dim == 80


def test_bridge_carries_mamba_leaves_as_they_are():
    """bf16 params: the dense and conv weights keep param_dtype, A_log, D
    and dt_bias stay float32, every leaf keeps its value."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, reduced=True),
                               param_dtype="bfloat16")
    jparams = _jax_params(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    mamba = params["layers"]["mamba"]
    for name in ("A_log", "D", "dt_bias"):
        assert mamba[name].dtype == torch.float32, name
    for name in ("conv_w", "conv_bc_w", "conv_b"):
        assert mamba[name].dtype == torch.bfloat16, name
    assert mamba["in_proj"]["w"].dtype == torch.bfloat16
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))


def test_init_params_and_cache_match_reference_layout():
    cfg = get_config(ARCH, reduced=True)
    jcfg = jax_get_config(ARCH, reduced=True)
    mine = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))

    def layout(tree, fn):
        return {k: layout(v, fn) if isinstance(v, dict) else fn(v)
                for k, v in tree.items()}

    jl = layout(ref, lambda x: (tuple(x.shape), str(x.dtype)))
    assert layout(mine, lambda t: (tuple(t.shape),
                                   str(t.dtype).split(".")[-1])) == jl
    cache = M.init_cache(cfg, 3, 32, "cpu")
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, 3, 32))
    assert layout(cache, lambda t: (tuple(t.shape),
                                    str(t.dtype).split(".")[-1])) \
        == layout(jcache, lambda x: (tuple(x.shape), str(x.dtype)))


@pytest.mark.parametrize("length", [1, 2, 3, 16, 21])
def test_mamba_apply_with_state_matches_jax(setup, length):
    """Prompts shorter than the conv width left-pad the projected tail;
    21 pads the scan to a chunk multiple."""
    s = setup
    rng = np.random.default_rng(length)
    x = rng.normal(size=(2, length, s["cfg"].d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[0], s["jparams"]["layers"]["mamba"])
    jout, jst = jax.jit(lambda p_, x_: JS.mamba_apply(
        p_, x_, s["jcfg"], return_state=True))(lp, jnp.asarray(x, s["jdtype"]))
    out, st = S.mamba_apply(_layer(s["params"]["layers"]["mamba"]),
                            torch.from_numpy(x).to(s["dtype"]), s["cfg"],
                            return_state=True)
    assert out.dtype == s["dtype"] and st["ssd"].dtype == torch.float32
    _close(out, jout, TOL[s["dt"]])
    for k in ("ssd", "conv", "conv_bc"):
        assert tuple(st[k].shape) == jst[k].shape, k
        _close(st[k], jst[k], TOL[s["dt"]])


def test_mamba_decode_matches_jax(setup):
    s = setup
    cfg = s["cfg"]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    state = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in
             S.mamba_init_state(cfg, 3, device="cpu").items()}
    lp = jax.tree.map(lambda a: a[0], s["jparams"]["layers"]["mamba"])
    jstate = {"ssd": jnp.asarray(state["ssd"]),
              "conv": jnp.asarray(state["conv"], s["jdtype"]),
              "conv_bc": jnp.asarray(state["conv_bc"], s["jdtype"])}
    jout, jnew = jax.jit(lambda p_, x_, st_: JS.mamba_decode(
        p_, x_, s["jcfg"], st_))(lp, jnp.asarray(x, s["jdtype"]), jstate)
    tstate = {"ssd": torch.from_numpy(state["ssd"]),
              "conv": torch.from_numpy(state["conv"]).to(s["dtype"]),
              "conv_bc": torch.from_numpy(state["conv_bc"]).to(s["dtype"])}
    out, new = S.mamba_decode(_layer(s["params"]["layers"]["mamba"]),
                              torch.from_numpy(x).to(s["dtype"]), cfg, tstate)
    _close(out, jout, TOL[s["dt"]])
    for k in new:
        _close(new[k], jnew[k], TOL[s["dt"]])


def test_ssm_stack_apply_matches_jax(setup):
    """The stack's prefill pass (collecting the states, in place here)
    and a decode step from them."""
    s = setup
    cfg = s["cfg"]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    stack = jax.jit(lambda p_, x_, st_, decode: JT.ssm_stack_apply(
        p_, x_, s["jcfg"], states=st_, decode=decode), static_argnums=3)
    jy, jst = stack(s["jparams"]["layers"], jnp.asarray(x, s["jdtype"]),
                    JM.init_cache(s["jcfg"], 2, 16), False)
    jy1, jst1 = stack(s["jparams"]["layers"], jnp.asarray(x1, s["jdtype"]),
                      jst, True)
    st = M.init_cache(cfg, 2, 16, "cpu")
    y, st = T.ssm_stack_apply(s["params"]["layers"],
                              torch.from_numpy(x).to(s["dtype"]), cfg,
                              states=st)
    _close(y, jy, MODEL_TOL[s["dt"]])
    for k in st:
        _close(st[k], jst[k], MODEL_TOL[s["dt"]])
    y1, st = T.ssm_stack_apply(s["params"]["layers"],
                               torch.from_numpy(x1).to(s["dtype"]), cfg,
                               states=st, decode=True)
    _close(y1, jy1, MODEL_TOL[s["dt"]])
    for k in st:
        _close(st[k], jst1[k], MODEL_TOL[s["dt"]])


def test_prefill_and_decode_step_match_jax(setup):
    s = setup
    cfg = s["cfg"]
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    prefill = jax.jit(lambda p_, t_, c_: JM.prefill(s["jcfg"], p_,
                                                    {"tokens": t_}, c_))
    step = jax.jit(lambda p_, t_, i_, c_: JM.decode_step(s["jcfg"], p_, t_,
                                                         i_, c_))
    jlog, jc = prefill(s["jparams"], jnp.asarray(tokens),
                       JM.init_cache(s["jcfg"], 2, 32))
    jlogs = [jlog]
    for i in range(3):
        jl, jc = step(s["jparams"], jnp.asarray(tokens[:, i:i + 1]),
                      jnp.int32(20 + i), jc)
        jlogs.append(jl)
    cache = M.init_cache(cfg, 2, 32, "cpu")
    log, cache = M.prefill(cfg, s["params"],
                           {"tokens": torch.from_numpy(tokens).long()}, cache)
    logs = [log]
    for i in range(3):
        log, cache = M.decode_step(cfg, s["params"],
                                   torch.from_numpy(tokens[:, i:i + 1]).long(),
                                   20 + i, cache)
        logs.append(log)
    for got, want in zip(logs, jlogs):
        assert got.dtype == torch.float32 and got.shape == want.shape
        _close(got[..., :cfg.vocab], want[..., :cfg.vocab], MODEL_TOL[s["dt"]])
    for k in cache:
        _close(cache[k], jc[k], MODEL_TOL[s["dt"]])


@pytest.mark.parametrize("lengths,gens,max_len", [
    ([8, 24, 16, 32], [5, 4, 7, 6], 64),      # the JAX serving test's CASES
    ([1, 2, 3, 8], [4, 4, 4, 4], 32),         # shorter than the conv width
], ids=["cases", "conv-tail"])
def test_engine_streams_match_jax_engine(lengths, gens, max_len):
    """4 requests over 2 slots (two admitted mid-stream into freed slots,
    idle rows stepping on garbage meanwhile), in float32: the greedy
    streams equal the JAX engine's token for token."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), dtype="float32")
    jparams = _jax_params(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in lengths]

    def streams(engine):
        reqs = [engine.submit(p, g) for p, g in zip(prompts, gens)]
        assert engine.run()["n_finished"] == len(reqs)
        return [r.generated for r in reqs]

    want = streams(JaxEngine(jcfg, jparams, max_slots=2, max_len=max_len))
    got = streams(ServingEngine(cfg, params, max_slots=2, max_len=max_len,
                                device="cpu"))
    assert got == want


def test_engine_serves_two_rounds_as_the_jax_engine():
    """One engine serves 4 requests over 2 slots, then 4 more once they
    have finished (remainder tokens in both rounds, a prompt shorter
    than the conv width in the second), on the sub-state and step
    inputs of the first round: each round's streams equal those of one
    JAX engine serving the same two rounds, token for token."""
    jcfg = dataclasses.replace(jax_get_config(ARCH, reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), dtype="float32")
    jparams = _jax_params(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(9)
    rounds = [[rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in lengths] for lengths in ([13, 24, 5, 19], [11, 2, 30, 9])]
    gens = [4, 3, 5, 4]

    def serve(engine):
        out = []
        for prompts in rounds:
            reqs = [engine.submit(p, g) for p, g in zip(prompts, gens)]
            engine.run()
            assert all(len(r.generated) == r.max_new_tokens for r in reqs)
            out.append([r.generated for r in reqs])
        return out

    want = serve(JaxEngine(jcfg, jparams, max_slots=2, max_len=48))
    got = serve(ServingEngine(cfg, params, max_slots=2, max_len=48,
                              device="cpu"))
    assert got == want


def test_ssm_refuses_what_it_does_not_serve():
    cfg = get_config(ARCH, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for kw in (dict(kv_layout="paged"), dict(kv_layout="paged", quant="int8"),
               dict(kv_layout="paged", quant_kv="int8")):
        with pytest.raises(ValueError, match="recurrent state"):
            ServingEngine(cfg, params, max_slots=1, max_len=16, device="cpu",
                          **kw)
    with pytest.raises(ValueError, match="recurrent state"):
        M.init_paged_cache(cfg, 4, 8, 1, 2, device="cpu")
    logits = M.forward(cfg, params,
                       {"tokens": torch.zeros(1, 4, dtype=torch.long)})
    assert logits.shape == (1, 4, cfg.padded_vocab)
    assert torch.isfinite(logits[..., :cfg.vocab]).all()
    eng = ServingEngine(cfg, params, max_slots=1, max_len=70, device="cpu")
    assert eng.max_len == 70            # no attn_chunk rounding for a state


def test_ssm_serves_int8_weights():
    """quant="int8" quantizes the stacked Mamba projections and lm_head
    (the embedding, norms, convs and A_log / D / dt_bias stay float), and
    the engine serves on them; `test_torch_quant.py` holds the streams to
    the JAX engine's."""
    cfg = get_config(ARCH, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServingEngine(cfg, params, max_slots=2, max_len=32, device="cpu",
                        quant="int8")
    mamba = eng.params["layers"]["mamba"]
    for name in ("in_proj", "in_proj_bc", "out_proj"):
        assert mamba[name]["w_q"].dtype == torch.int8, name
    assert eng.params["lm_head"]["w_q"].dtype == torch.int8
    assert mamba["conv_w"].is_floating_point()
    reqs = [eng.submit(np.arange(n, dtype=np.int32) % cfg.vocab, 4)
            for n in (5, 13)]
    eng.run()
    assert all(len(r.generated) == 4 for r in reqs)


def test_serve_cli_mamba2(capsys):
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--requests", "4", "--max-slots", "2"])
    assert "arch=mamba2-2.7b-reduced" in capsys.readouterr().out
    assert out["n_finished"] == 4
    with pytest.raises(ValueError, match="recurrent state"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--kv-layout", "paged", "--quant-kv", "int8"])
