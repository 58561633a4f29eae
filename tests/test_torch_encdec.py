"""The encdec family, whisper-tiny, at its reduced size (2 encoder and 2
decoder layers, d 64, 4 heads of 16, 32 encoder frames) against the JAX
package on the same weights (the JAX params, with every bias and norm
drawn from a seed in place of the zeros and ones they start from, bridged
leaf for leaf) and the same numpy inputs: the config, the bridged tree,
the init layouts, `layernorm_apply` and the sinusoids, `forward`,
`prefill` then `decode_step` at a per-slot position vector with an idle
slot, the serving engine's greedy streams on float and on int8 weights
(one trace from `synthetic_trace`, whose frames both packages draw
alike), the refusals, and the serve CLI. The JAX side runs jitted under
its default policy (plain XLA: the chunked attention path in f32).

Stated tolerances: float32 atol = rtol = 1e-4 for the models' logits
and caches (the port's non-causal attention is the flash kernel's plain
version, the reference's the chunked online softmax: the same function,
summed in another order); bfloat16 atol = rtol = 2^-4 (the roundings
compound over the layers); the layernorm within 1e-5; the sinusoids
within two f32 ulps of their largest angle, pos * 1 (XLA's sin and cos
of a large f32 angle differ from PyTorch's by up to one ulp of it:
2^-12 at positions up to 2047); the engines' streams token for token in
float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.policy import Policy
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import ServingEngine as JaxEngine
from repro.serving import workload as JW
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.tree import leaves, tree_map
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving import ServingEngine, synthetic_trace
from repro_torch.serving.request import FINISHED

ARCH = "whisper-tiny"
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2 ** -4, rtol=2 ** -4)}
# engine trace: 4 requests over 2 slots; request 2 decodes 14 tokens,
# alone for most of them, while the other slot stays idle
GENS = [3, 4, 14, 2]
MAX_LEN = 40


def _cfgs(dt):
    jcfg = dataclasses.replace(jax_get_config(ARCH, reduced=True), dtype=dt)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), dtype=dt)
    return jcfg, cfg


def jax_params(jcfg):
    """The JAX package's init, each bias ("b", a norm's "bias") and norm
    scale then drawn from a seed: at init they are zeros and ones, and a
    bias path that adds nothing would pass any test."""
    p = jax.jit(lambda k: JM.init_params(jcfg, k))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)

    def draw(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = draw(v)
            elif k in ("b", "bias"):
                out[k] = jnp.asarray(rng.normal(size=v.shape) * 0.1, v.dtype)
            elif k == "scale":
                out[k] = jnp.asarray(1 + rng.normal(size=v.shape) * 0.1,
                                     v.dtype)
            else:
                out[k] = v
        return out
    return draw(p)


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
    """float32 configs and params, and one trace drawn by both packages'
    `synthetic_trace` from one seed, for the engines."""
    jcfg, cfg = _cfgs("float32")
    jparams = jax_params(jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    work = synthetic_trace(cfg, 4, rng=np.random.default_rng(42),
                           len_range=(5, 21), gen=4)
    jwork = JW.synthetic_trace(jcfg, 4, rng=np.random.default_rng(42),
                               len_range=(5, 21), gen=4)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                work=work, jwork=jwork)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


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
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.norm, cfg.mlp, cfg.use_rope) == \
        ("encdec", "ln", "gelu", False)
    assert (cfg.n_layers, cfg.n_enc_layers, cfg.enc_ctx) == (4, 4, 1500)
    assert cfg.padded_vocab == 51968 and cfg.tie_embeddings
    red = get_config(ARCH, reduced=True)
    assert (red.n_layers, red.n_enc_layers, red.enc_ctx) == (2, 2, 32)


def test_bridge_carries_the_encdec_tree_leaf_for_leaf(setup):
    """Every leaf, the stacked encoder and decoder blocks, each norm's
    bias and the MLP and cross-attention weights included, keeps its
    shape, dtype and value."""
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
        n += 1
    p = setup["params"]
    assert set(p) == {"embed", "final_norm", "enc_layers", "enc_final_norm",
                      "dec_layers"}
    assert p["enc_layers"]["mlp"]["w_in"]["b"].shape == (2, 128)
    assert p["dec_layers"]["cross_attn"]["wq"]["w"].shape == (2, 64, 64)
    assert p["dec_layers"]["cross_norm"]["bias"].shape == (2, 64)
    assert "cross_attn" not in p["enc_layers"]
    assert n == len(leaves(p))


def test_init_params_and_cache_match_reference_layout():
    jcfg, cfg = _cfgs("bfloat16")
    mine = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    assert _layout(mine, _torch_layout) == _layout(ref, _jax_layout)
    assert not mine["enc_layers"]["mlp"]["w_out"]["b"].any()
    cache = M.init_cache(cfg, 3, 24, "cpu")
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, 3, 24))
    assert _layout(cache, _torch_layout) == _layout(jcache, _jax_layout)
    assert cache["cross"]["k"].shape == (2, 3, 32, 4, 16)
    assert cache["self"]["v"].shape == (2, 3, 24, 4, 16)
    # the encoder's init scales read its own depth
    enc = jax.eval_shape(lambda: JM.init_params(
        dataclasses.replace(jcfg, n_enc_layers=3), jax.random.PRNGKey(0)))
    assert enc["enc_layers"]["attn"]["wo"]["w"].shape[0] == 3


def test_layernorm_and_sinusoids_match_jax():
    rng = np.random.default_rng(0)
    for d in (64, 384):
        x = (rng.normal(size=(3, 5, d)) * 3 + 1).astype(np.float32)
        p = {"scale": (1 + rng.normal(size=d) * 0.1).astype(np.float32),
             "bias": (rng.normal(size=d) * 0.1).astype(np.float32)}
        want = JL.layernorm_apply(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x))
        got = L.layernorm_apply(tree_map(torch.from_numpy, p),
                                torch.from_numpy(x))
        _close(got, want, dict(atol=1e-5, rtol=1e-5))
        xb = torch.from_numpy(x).to(torch.bfloat16)
        got_b = L.layernorm_apply(tree_map(torch.from_numpy, p), xb)
        assert got_b.dtype == torch.bfloat16
        _close(got_b, JL.layernorm_apply(
            jax.tree.map(jnp.asarray, p),
            jnp.asarray(xb.float().numpy(), jnp.bfloat16)),
            dict(atol=2 ** -6, rtol=2 ** -6))
        # a row's bits at 1 and at 15 rows
        one = L.layernorm_apply(tree_map(torch.from_numpy, p),
                                torch.from_numpy(x[1:2, 2:3]))
        assert torch.equal(one[0, 0], got[1, 2])
    def ulps(top):
        return dict(atol=2 * float(np.spacing(np.float32(top))), rtol=0)
    for t, d, off in ((50, 64, 0), (7, 384, 1993)):
        _close(L.sinusoid_positions(t, d, off),
               JL.sinusoid_positions(t, d, off), ulps(off + t - 1))
    pos = np.array([0, 5, -1, 1999], np.int32)
    _close(L.sinusoid_at(64, torch.from_numpy(pos)),
           JM._sinusoid_at(64, jnp.asarray(pos)), ulps(1999))
    assert L.sinusoid_at(64, torch.tensor(3)).shape == (64,)


def _batch(cfg, b, t, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    frames = rng.normal(size=(b, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
    return toks, frames


def test_forward_matches_jax(setup):
    """The training forward: encoder, decoder with cross-attention over
    K/V projected from the encoder's output, tied logits."""
    s = setup
    cfg, jcfg = s["cfg"], s["jcfg"]
    toks, frames = _batch(cfg, 2, 12, 1)
    jlog, _ = jax.jit(lambda p_, b_: JM.forward(jcfg, p_, b_))(
        s["jparams"], {"tokens": jnp.asarray(toks),
                       "enc_frames": jnp.asarray(frames)})
    log = M.forward(cfg, s["params"],
                    {"tokens": torch.from_numpy(toks).long(),
                     "enc_frames": torch.from_numpy(frames)})
    assert log.dtype == torch.float32 and log.shape == jlog.shape
    _close(log[..., :cfg.vocab], jlog[..., :cfg.vocab], TOL[s["dt"]])
    assert (log[..., cfg.vocab:] == -1e30).all()
    # the encoder is live: other frames give other logits
    other = M.forward(cfg, s["params"],
                      {"tokens": torch.from_numpy(toks).long(),
                       "enc_frames": torch.from_numpy(frames[::-1].copy())})
    assert (other[0] - log[0]).abs().max() > 0.01


def test_prefill_and_decode_step_match_jax(setup):
    """prefill of 10 tokens into two slots, then two decode steps at a
    per-slot position vector with slot 1 idle: slot 0's logits and self
    cache rows, and both slots' cross caches; then a decode step at an
    int position with both slots busy."""
    s = setup
    cfg, jcfg = s["cfg"], s["jcfg"]
    toks, frames = _batch(cfg, 2, 10, 2)
    nxt = np.random.default_rng(3).integers(0, cfg.vocab, (3, 2, 1))
    prefill = jax.jit(lambda p_, b_, c_: JM.prefill(jcfg, p_, b_, c_))
    step = jax.jit(lambda p_, t_, i_, c_: JM.decode_step(jcfg, p_, t_, i_,
                                                         c_))
    jlog, jc = prefill(s["jparams"], {"tokens": jnp.asarray(toks),
                                      "enc_frames": jnp.asarray(frames)},
                       JM.init_cache(jcfg, 2, 16))
    cache = M.init_cache(cfg, 2, 16, "cpu")
    log, cache2 = M.prefill(cfg, s["params"],
                            {"tokens": torch.from_numpy(toks).long(),
                             "enc_frames": torch.from_numpy(frames)}, cache)
    assert cache2 is cache
    _close(log[..., :cfg.vocab], jlog[..., :cfg.vocab], TOL[s["dt"]])
    for name in ("self", "cross"):
        for kv in ("k", "v"):
            _close(cache[name][kv], jc[name][kv], TOL[s["dt"]])
    pos = np.array([10, -1], np.int32)
    for i in range(2):
        jl, jc = step(s["jparams"], jnp.asarray(nxt[i], jnp.int32),
                      jnp.asarray(pos + np.array([i, 0], np.int32)), jc)
        lg, _ = M.decode_step(
            cfg, s["params"], torch.from_numpy(nxt[i]).long(),
            torch.from_numpy(pos + np.array([i, 0], np.int32)), cache)
        _close(lg[:1, :, :cfg.vocab], np.asarray(jl)[:1, :, :cfg.vocab],
               TOL[s["dt"]])
    for kv in ("k", "v"):
        _close(cache["self"][kv][:, :1], np.asarray(jc["self"][kv])[:, :1],
               TOL[s["dt"]])
        # the idle slot's rows past its prompt stay zeros on both sides
        assert not cache["self"][kv][:, 1, 10:].any()
        _close(cache["cross"][kv], jc["cross"][kv], TOL[s["dt"]])
    jl, _ = step(s["jparams"], jnp.asarray(nxt[2], jnp.int32),
                 jnp.int32(12), jc)
    lg, _ = M.decode_step(cfg, s["params"], torch.from_numpy(nxt[2]).long(),
                          12, cache)
    _close(lg[..., :cfg.vocab], np.asarray(jl)[..., :cfg.vocab], TOL[s["dt"]])


def test_trace_frames_match_jax(f32):
    """One seed, one trace: the prompts, budgets, arrivals and each
    request's encoder frames, drawn right after its prompt in both."""
    assert len(f32["work"]) == len(f32["jwork"])
    for a, b in zip(f32["work"], f32["jwork"]):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.gen, a.arrival, a.deadline, a.priority) == \
            (b.gen, b.arrival, b.deadline, b.priority)
        assert a.enc_frames.shape == (32, 64)
        np.testing.assert_array_equal(a.enc_frames, b.enc_frames)
    plain = synthetic_trace(get_config("qwen3-0.6b", reduced=True), 2,
                            rng=np.random.default_rng(0))
    assert all(it.enc_frames is None for it in plain)


def _serve(engine, work, gens=GENS):
    reqs = [engine.submit(it.prompt, g, enc_frames=it.enc_frames)
            for it, g in zip(work, gens)]
    engine.run()
    assert all(r.status == FINISHED for r in reqs)
    return [r.generated for r in reqs]


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_engine_streams_match_jax_engine(f32, quant):
    """4 requests over 2 slots in float32, on float and on int8 weights
    (encoder, decoder and cross-attention weights int8, the embedding
    float): the greedy streams equal the JAX engine's token for token;
    served again, each request alone, each stream is the same."""
    want = _serve(JaxEngine(f32["jcfg"], f32["jparams"], max_slots=2,
                            max_len=MAX_LEN, policy=Policy(quant=quant)),
                  f32["jwork"])
    eng = ServingEngine(f32["cfg"], f32["params"], max_slots=2,
                        max_len=MAX_LEN, device="cpu", quant=quant)
    assert eng._slot_axes == [1, 1, 1, 1]
    if quant == "int8":
        dec = eng.params["dec_layers"]
        assert dec["cross_attn"]["wk"]["w_q"].dtype == torch.int8
        assert dec["mlp"]["w_in"]["w_q"].dtype == torch.int8
        assert eng.params["enc_layers"]["attn"]["wq"]["w_q"].dtype == \
            torch.int8
        assert dec["mlp"]["w_in"]["b"].dtype == torch.float32
        assert eng.params["embed"]["w"].dtype == torch.float32
    got = _serve(eng, f32["work"])
    assert got == want
    assert eng.decode_steps > 10                  # the idle-slot stretch
    for it, g, stream in zip(f32["work"], GENS, got):
        assert _serve(eng, [it], [g]) == [stream]


def test_engine_admission_copies_the_cross_cache_into_the_slot(f32):
    """After an admission into slot 1, its cross and self rows are the
    sub-cache's, and slot 0's are untouched."""
    eng = ServingEngine(f32["cfg"], f32["params"], max_slots=2,
                        max_len=MAX_LEN, device="cpu")
    work = f32["work"]
    eng.submit(work[0].prompt, 8, enc_frames=work[0].enc_frames)
    eng.submit(work[1].prompt, 8, enc_frames=work[1].enc_frames)
    eng.step()
    before = tree_map(lambda t: t.clone(), eng.cache)
    eng.scheduler.release(1, "finished")
    eng._free_slot(1)
    eng.submit(work[2].prompt, 4, enc_frames=work[2].enc_frames)
    eng._admit(eng.scheduler.next_admission(eng._now()))
    for big, old, one in zip(leaves(eng.cache), leaves(before),
                             leaves(eng._sub)):
        assert torch.equal(big[:, 1], one[:, 0])
        assert torch.equal(big[:, 0], old[:, 0])
    assert eng.cache["cross"]["k"][:, 1].abs().max() > 0


def test_encdec_refuses_what_it_does_not_serve():
    cfg = get_config(ARCH, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for kw in (dict(kv_layout="paged"),
               dict(kv_layout="paged", quant_kv="int8"),
               dict(kv_layout="paged", quant="int8")):
        with pytest.raises(ValueError, match=r"encdec.*cross cache"):
            ServingEngine(cfg, params, max_slots=1, max_len=16, device="cpu",
                          **kw)
    with pytest.raises(ValueError, match="quant_kv"):
        ServingEngine(cfg, params, max_slots=1, max_len=16, device="cpu",
                      quant_kv="int8")
    with pytest.raises(ValueError, match="cross cache"):
        M.init_paged_cache(cfg, 4, 8, 1, 2, device="cpu")
    with pytest.raises(ValueError, match="no per-request encoder cache"):
        ServingEngine(cfg, params, max_slots=1, max_len=16, device="cpu",
                      draft=(cfg, params))
    dense = get_config("qwen3-0.6b", reduced=True)
    dparams = M.init_params(dense, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="no per-request encoder cache"):
        ServingEngine(dense, dparams, max_slots=1, max_len=16, device="cpu",
                      draft=(cfg, params))
    with pytest.raises(ValueError, match="cross cache"):
        M.verify_step(cfg, params, torch.zeros((1, 2), dtype=torch.long),
                      torch.zeros(1, dtype=torch.int32),
                      torch.ones(1, dtype=torch.int32),
                      M.init_cache(cfg, 1, 8, "cpu"))
    eng = ServingEngine(cfg, params, max_slots=1, max_len=70, device="cpu")
    assert eng.max_len == 128           # rounded to attn_chunk, as dense
    assert eng.cache["cross"]["k"].shape[2] == cfg.enc_ctx
    with pytest.raises(ValueError, match="need enc_frames"):
        eng.submit(np.arange(4), 2)
    with pytest.raises(ValueError, match=r"takes \(32, 64\)"):
        eng.submit(np.arange(4), 2, enc_frames=np.zeros((16, 64)))
    dense_eng = ServingEngine(dense, dparams, max_slots=1, max_len=16,
                              device="cpu")
    with pytest.raises(ValueError, match="encdec request"):
        dense_eng.submit(np.arange(4), 2, enc_frames=np.zeros((32, 64)))
    for bad in (dict(norm="rms"), dict(mlp="swiglu"), dict(n_enc_layers=0)):
        with pytest.raises(ValueError, match="encoder-decoders"):
            M.init_params(dataclasses.replace(cfg, **bad),
                          torch.Generator().manual_seed(0), "cpu")


def test_serve_cli_whisper(capsys):
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--requests", "4", "--max-slots", "2",
                      "--prompt-len-min", "4", "--prompt-len-max", "20",
                      "--gen", "4"])
    assert "arch=whisper-tiny-reduced" in capsys.readouterr().out
    assert out["n_finished"] == 4
    with pytest.raises(ValueError, match="encdec"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--kv-layout", "paged"])
