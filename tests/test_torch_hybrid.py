"""The port's zamba2 (reduced, at 4 layers: two segments of 2 Mamba
layers, so two LoRA pairs and two attention caches) against the JAX
package's: the config, the bridged params, the init layouts, the hybrid
stack (prefill with its states, a decode step with an idle slot), the
model's prefill / decode_step, and the serving engine's greedy streams,
on float and on int8 weights; on the same weights (the JAX params, with
a seeded random lora_b in place of the zeros it starts from, bridged
leaf for leaf) and the same numpy inputs. The JAX side runs jitted under
its default policy (its SSD scan the plain reference of the Pallas
kernel; `test_torch_ssd.py` holds the port's scan against the kernel).

Stated tolerances, as `test_torch_mamba.py`'s: float32 atol = rtol =
1e-4 for the stack's and the model's outputs, states and caches;
bfloat16 atol = rtol = 2^-4 (XLA's bf16 elementwise ops round at other
places than PyTorch's, and those roundings compound over the layers);
the engines' streams token for token in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.policy import Policy
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.tree import leaves, tree_map
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.serving import ServingEngine
from repro_torch.serving.request import FINISHED

ARCH = "zamba2-1.2b"
N_LAYERS = 4                     # two segments of attn_every = 2
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2 ** -4, rtol=2 ** -4)}
# engine trace: 2 slots; 13 and 21 run remainder steps, 5 is shorter than
# a bucket; request 2 decodes 30 tokens, alone for most of them, while
# the other slot stays idle
LENGTHS = [8, 13, 21, 5]
GENS = [3, 4, 30, 2]
MAX_LEN = 64


def _cfgs(dt):
    jcfg = dataclasses.replace(jax_get_config(ARCH, reduced=True),
                               n_layers=N_LAYERS, dtype=dt)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              n_layers=N_LAYERS, dtype=dt)
    return jcfg, cfg


def jax_params(jcfg):
    """The JAX package's init, lora_b then drawn from a seed: at init it is
    zeros, and a LoRA path that computes nothing would pass any test."""
    p = jax.jit(lambda k: JM.init_params(jcfg, k))(jax.random.PRNGKey(0))
    lb = p["hybrid"]["lora_b"]
    rng = np.random.default_rng(7)
    p["hybrid"]["lora_b"] = jnp.asarray(
        rng.normal(size=lb.shape) * lb.shape[1] ** -0.5, lb.dtype)
    return p


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def setup(request):
    dt = request.param
    jcfg, cfg = _cfgs(dt)
    jparams = jax_params(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return dict(dt=dt, jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                jdtype=jnp.dtype(dt), dtype=getattr(torch, dt))


@pytest.fixture(scope="module")
def f32():
    """float32 configs and params, and the trace, for the engines."""
    jcfg, cfg = _cfgs("float32")
    jparams = jax_params(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in LENGTHS]
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                prompts=prompts)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _close_tree(got, want, tol, rows=slice(None), axis_of=None):
    """Every leaf of the port's cache tree against the JAX one's; `rows`
    picks slots along each leaf's slot axis (`axis_of(path)`)."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for key in path:
            node = node[key.key]
        ax = axis_of(path) if axis_of else 0
        idx = (slice(None),) * ax + (rows,)
        _close(node[idx], np.asarray(leaf, np.float32)[idx], tol)


def _slot_axis(path):
    return 2 if path[0].key == "mamba" else 1


def _layout(tree, fn):
    return {k: _layout(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _torch_layout(t):
    return tuple(t.shape), str(t.dtype).split(".")[-1]


def _jax_layout(x):
    return tuple(x.shape), str(x.dtype)


def test_config_matches_reference():
    for reduced in (False, True):
        a = dataclasses.asdict(get_config(ARCH, reduced=reduced))
        b = dataclasses.asdict(jax_get_config(ARCH, reduced=reduced))
        assert a == {k: v for k, v in b.items() if k in a}
        assert not get_config(ARCH, reduced=reduced).is_attention_free
    cfg = get_config(ARCH)
    assert cfg.family == "hybrid" and cfg.n_layers // cfg.attn_every == 6
    assert cfg.padded_vocab == 32000 and not cfg.tie_embeddings
    assert (cfg.ssm.expand * cfg.d_model) // cfg.ssm.head_dim == 64
    assert get_config(ARCH, reduced=True).attn_every == 2


def test_bridge_carries_the_hybrid_tree_leaf_for_leaf(setup):
    """Every leaf, the (n_seg, attn_every, ...) Mamba stacks and the
    (n_seg, ...) LoRA pairs included, keeps its shape, dtype and value."""
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            setup["jparams"])[0]:
        node = setup["params"]
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))
        n += node.dim() >= 4
    mamba = setup["params"]["hybrid"]["mamba"]
    assert mamba["mamba"]["in_proj"]["w"].shape[:2] == (2, 2)
    assert n >= 4, "expected the 4-D stacked Mamba leaves"


def test_init_params_and_cache_match_reference_layout():
    jcfg, cfg = _cfgs("bfloat16")
    mine = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    assert _layout(mine, _torch_layout) == _layout(ref, _jax_layout)
    assert not mine["hybrid"]["lora_b"].any()       # zeros, as the reference
    cache = M.init_cache(cfg, 3, 32, "cpu")
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, 3, 32))
    assert _layout(cache, _torch_layout) == _layout(jcache, _jax_layout)
    assert cache["attn"]["k"].shape == (2, 3, 32, 4, 16)
    assert cache["mamba"]["ssd"].shape == (2, 2, 3, 16, 8, 16)


def _jax_hybrid(jcfg, decode):
    return jax.jit(lambda p_, x_, e_, c_, s_, pos_: JT.hybrid_apply(
        p_, x_, jcfg, emb0=e_, attn_caches=c_, cache_pos=pos_,
        mamba_states=s_, decode=decode))


def test_hybrid_apply_matches_jax(setup):
    """A 12-token prefill into the caches from position 0, collecting the
    states, then a decode step at a per-slot position vector with slot 1
    idle: outputs (slot 0 at decode), KV caches (the idle slot's rows
    untouched on both sides) and slot 0's states. emb0 is an input of its
    own. A LoRA of zeros gives another output: the LoRA path is live."""
    s = setup
    cfg, jcfg = s["cfg"], s["jcfg"]
    rng = np.random.default_rng(1)
    x, e = (rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
            for _ in range(2))
    x1, e1 = (rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
              for _ in range(2))
    pos = np.array([12, -1], np.int32)
    jc = JM.init_cache(jcfg, 2, 16)
    jy, jattn, jst = _jax_hybrid(jcfg, False)(
        s["jparams"]["hybrid"], jnp.asarray(x, s["jdtype"]),
        jnp.asarray(e, s["jdtype"]), jc["attn"], jc["mamba"], 0)
    jy1, jattn1, jst1 = _jax_hybrid(jcfg, True)(
        s["jparams"]["hybrid"], jnp.asarray(x1, s["jdtype"]),
        jnp.asarray(e1, s["jdtype"]), jattn, jst, jnp.asarray(pos))

    def t(a):
        return torch.from_numpy(a).to(s["dtype"])

    cache = M.init_cache(cfg, 2, 16, "cpu")
    y, attn, st = T.hybrid_apply(s["params"]["hybrid"], t(x), cfg, emb0=t(e),
                                 attn_caches=cache["attn"], cache_pos=0,
                                 mamba_states=cache["mamba"])
    assert attn is cache["attn"] and st is cache["mamba"]   # in place
    _close(y, jy, TOL[s["dt"]])
    _close_tree(cache, {"attn": jattn, "mamba": jst}, TOL[s["dt"]])
    y1, _, _ = T.hybrid_apply(s["params"]["hybrid"], t(x1), cfg, emb0=t(e1),
                              attn_caches=cache["attn"],
                              cache_pos=torch.from_numpy(pos),
                              mamba_states=cache["mamba"], decode=True)
    _close(y1[:1], np.asarray(jy1, np.float32)[:1], TOL[s["dt"]])
    _close_tree(cache, {"attn": jattn1}, TOL[s["dt"]])
    _close_tree(cache, {"mamba": jst1}, TOL[s["dt"]], rows=slice(0, 1),
                axis_of=_slot_axis)

    no_lora = dict(s["params"]["hybrid"],
                   lora_b=torch.zeros_like(s["params"]["hybrid"]["lora_b"]))
    y0, _, _ = T.hybrid_apply(no_lora, t(x), cfg, emb0=t(e))
    assert (y0 - y).abs().max() > 0.1


def test_hybrid_apply_without_caches_matches_jax(setup):
    """The cache-less pass (causal attention over the call's own tokens,
    the training forward's route) against the reference's."""
    s = setup
    cfg, jcfg = s["cfg"], s["jcfg"]
    x = np.random.default_rng(2).normal(
        size=(2, 10, cfg.d_model)).astype(np.float32)
    jy, _, _ = jax.jit(lambda p_, x_: JT.hybrid_apply(p_, x_, jcfg, emb0=x_))(
        s["jparams"]["hybrid"], jnp.asarray(x, s["jdtype"]))
    xt = torch.from_numpy(x).to(s["dtype"])
    y, _, _ = T.hybrid_apply(s["params"]["hybrid"], xt, cfg, emb0=xt)
    _close(y, jy, TOL[s["dt"]])


def test_prefill_and_decode_step_match_jax(setup):
    """prefill of 20 tokens, then 3 decode steps at an int position:
    logits and every cache leaf."""
    s = setup
    cfg, jcfg = s["cfg"], s["jcfg"]
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 20)).astype(np.int32)
    prefill = jax.jit(lambda p_, t_, c_: JM.prefill(jcfg, p_, {"tokens": t_},
                                                    c_))
    step = jax.jit(lambda p_, t_, i_, c_: JM.decode_step(jcfg, p_, t_, i_, c_))
    jlog, jc = prefill(s["jparams"], jnp.asarray(tokens),
                       JM.init_cache(jcfg, 2, 32))
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
        _close(got[..., :cfg.vocab], want[..., :cfg.vocab], TOL[s["dt"]])
    _close_tree(cache, jc, TOL[s["dt"]])


def _serve(engine, prompts, gens=GENS):
    reqs = [engine.submit(p, g) for p, g in zip(prompts, gens)]
    engine.run()
    assert all(r.status == FINISHED for r in reqs)
    return [r.generated for r in reqs]


def test_engine_streams_match_jax_engine(f32):
    """4 requests over 2 slots in float32 (two admitted mid-stream into
    freed slots; remainder steps; one slot idle for ~25 steps, its Mamba
    state stepping on garbage): the greedy streams equal the JAX engine's
    token for token; served again, each request alone, each stream is
    the same."""
    want = _serve(JaxEngine(f32["jcfg"], f32["jparams"], max_slots=2,
                            max_len=MAX_LEN), f32["prompts"])
    eng = ServingEngine(f32["cfg"], f32["params"], max_slots=2,
                        max_len=MAX_LEN, device="cpu")
    assert [ax for ax in eng._slot_axes] == [1, 1, 2, 2, 2]
    got = _serve(eng, f32["prompts"])
    assert got == want
    assert eng.decode_steps > 30                  # the idle-slot stretch
    for p, g, stream in zip(f32["prompts"], GENS, got):
        assert _serve(eng, [p], [g]) == [stream]


def test_engine_admission_copies_each_leaf_along_its_slot_axis(f32):
    """After an admission into slot 1, every cache leaf's slot-1 row is
    the sub-cache's, and slot 0's rows are untouched."""
    eng = ServingEngine(f32["cfg"], f32["params"], max_slots=2,
                        max_len=MAX_LEN, device="cpu")
    eng.submit(f32["prompts"][0], 8)
    eng.submit(f32["prompts"][1], 8)
    eng.step()
    before = tree_map(lambda t: t.clone(), eng.cache)
    eng.scheduler.release(1, "finished")
    eng._free_slot(1)
    eng.submit(f32["prompts"][2], 4)
    eng._admit(eng.scheduler.next_admission(eng._now()))
    for name, big, old, one in zip(("k", "v", "conv", "conv_bc", "ssd"),
                                   leaves(eng.cache), leaves(before),
                                   leaves(eng._sub)):
        ax = 1 if name in ("k", "v") else 2
        assert torch.equal(big.select(ax, 1), one.select(ax, 0)), name
        assert torch.equal(big.select(ax, 0), old.select(ax, 0)), name


def test_hybrid_refuses_what_it_does_not_serve():
    cfg = get_config(ARCH, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for kw in (dict(kv_layout="paged"),
               dict(kv_layout="paged", quant_kv="int8"),
               dict(kv_layout="paged", quant="int8")):
        with pytest.raises(ValueError, match=r"hybrid.*recurrent state"):
            ServingEngine(cfg, params, max_slots=1, max_len=16, device="cpu",
                          **kw)
    with pytest.raises(ValueError, match="quant_kv"):
        ServingEngine(cfg, params, max_slots=1, max_len=16, device="cpu",
                      quant_kv="int8")
    with pytest.raises(ValueError, match="recurrent state"):
        M.init_paged_cache(cfg, 4, 8, 1, 2, device="cpu")
    with pytest.raises(ValueError, match="verify-capable"):
        ServingEngine(cfg, params, max_slots=1, max_len=16, device="cpu",
                      draft=(cfg, params))
    with pytest.raises(ValueError, match="attention cache alone"):
        M.verify_step(cfg, params, torch.zeros((1, 2), dtype=torch.long),
                      torch.zeros(1, dtype=torch.int32),
                      torch.ones(1, dtype=torch.int32),
                      M.init_cache(cfg, 1, 8, "cpu"))
    logits = M.forward(cfg, params,
                       {"tokens": torch.zeros(1, 4, dtype=torch.long)})
    assert logits.shape == (1, 4, cfg.padded_vocab)
    assert torch.isfinite(logits[..., :cfg.vocab]).all()
    with pytest.raises(ValueError, match="whole segments"):
        M.init_params(dataclasses.replace(cfg, n_layers=3),
                      torch.Generator().manual_seed(0), "cpu")
    eng = ServingEngine(cfg, params, max_slots=1, max_len=70, device="cpu")
    assert eng.max_len == 128           # rounded to attn_chunk, as dense


def test_serve_cli_zamba2(capsys):
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--requests", "4", "--max-slots", "2"])
    assert "arch=zamba2-1.2b-reduced" in capsys.readouterr().out
    assert out["n_finished"] == 4
    with pytest.raises(ValueError, match="hybrid"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--kv-layout", "paged"])


# ----------------------------------------------------------------------
# int8 weights
# ----------------------------------------------------------------------

def test_engine_int8_streams_match_jax_engine(f32):
    """quant="int8" on both engines (the shared block, its input
    projection and lm_head in int8; the 4-D Mamba stacks and the LoRA
    pairs float): the greedy streams token for token, and each request
    alone gives its stream."""
    want = _serve(JaxEngine(f32["jcfg"], f32["jparams"], max_slots=2,
                            max_len=MAX_LEN, policy=Policy(quant="int8")),
                  f32["prompts"])
    eng = ServingEngine(f32["cfg"], f32["params"], max_slots=2,
                        max_len=MAX_LEN, device="cpu", quant="int8")
    hp = eng.params["hybrid"]
    assert hp["shared"]["in_proj"]["w_q"].dtype == torch.int8
    assert hp["shared"]["block"]["mlp"]["w_down"]["w_q"].dtype == torch.int8
    assert hp["mamba"]["mamba"]["in_proj"]["w"].dtype == torch.float32
    assert eng.params["lm_head"]["w_q"].dtype == torch.int8
    got = _serve(eng, f32["prompts"])
    assert got == want
    for p, g, stream in zip(f32["prompts"], GENS, got):
        assert _serve(eng, [p], [g]) == [stream]
