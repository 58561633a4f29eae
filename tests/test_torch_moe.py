"""The moe family, mixtral-8x22b (8 experts top-2, a sliding window) and
arctic-480b (128 experts top-2 and a parallel dense branch), at their
reduced sizes (4 experts, groups of 32, window 32) against the JAX package
on the same weights (the JAX params, bridged leaf for leaf) and the same
numpy inputs: the configs, the bridged trees, `quantize_params`' walk,
the batched GEMM and dual GEMM's plain versions against the vmapped JAX
chokepoints, the router and `moe_apply` with dropped assignments present
(both dispatch modes), `forward` with its aux, `prefill` then
`decode_step` on a dense cache and on bf16 and int8 page pools (mixtral's
prompts past its window), `verify_step`, the serving engine's greedy
streams against the JAX engine's, and the serve CLI.

Both sides in float32; the JAX side under `Policy(backend="pallas",
interpret=True)`, where its expert banks run the vmapped Pallas kernels.
Tolerance: atol 1e-4 on logits and caches, 1e-6 on the layer outputs and
the aux; int8 pages within one quantization step; routing (expert ids,
capacity positions, kept assignments) and streams exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import gemm as JG
from repro.core.policy import Policy
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import gemm, precision
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import moe as PMoE
from repro_torch.serving import ServingEngine
from repro_torch.serving.steps import place_params

ATOL = 1e-4
PALLAS = Policy(backend="pallas", interpret=True)
ARCHS = ("mixtral-8x22b", "arctic-480b")
B, T, MAX_LEN, PS = 3, 40, 48, 8     # 40 > mixtral's reduced window of 32
# a verify step's B x 4 tokens route as one group, where an idle slot's
# rows and rows past n_tok (zero rows in the port's attention, the
# reference's attend what its masks leave) compete for capacity: every
# slot is busy and every row real
POS = np.array([40, 41, 42], np.int32)
N_TOK = np.array([4, 4, 4], np.int32)


def _cfgs(arch, dispatch=None):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    if dispatch is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, dispatch=dispatch))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
    return jcfg, cfg


def as_jax(tree):
    return jax.tree.map(lambda x: jnp.asarray(x.numpy()), tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, cfg = _cfgs(arch)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    m = dict(arch=arch, jcfg=jcfg, cfg=cfg, jparams=jparams, params=params)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (B, T)) \
        .astype(np.int32)
    with PALLAS.scope():
        m["jlog"], m["jcache"] = JM.prefill(
            jcfg, jparams, {"tokens": jnp.asarray(tokens)},
            JM.init_cache(jcfg, B, MAX_LEN))
    m["log"], m["cache"] = M.prefill(
        cfg, params, {"tokens": torch.from_numpy(tokens).long()},
        M.init_cache(cfg, B, MAX_LEN, "cpu"))
    return m


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for reduced in (False, True):
        a = dataclasses.asdict(get_config(arch, reduced=reduced))
        b = dataclasses.asdict(jax_get_config(arch, reduced=reduced))
        assert a == {k: v for k, v in b.items() if k in a}, (arch, reduced)
        assert a["moe"] == b["moe"] and a["family"] == "moe"
        assert set(b) - set(a) <= {"n_enc_layers", "enc_ctx",
                                   "shard_attn_seq", "constrain_mode",
                                   "scan_layers", "max_position"}
    mc = get_config(arch, reduced=True).moe
    assert (mc.n_experts, mc.top_k, mc.group_size) == (4, 2, 32)


def test_bridge_carries_the_moe_tree(model):
    """Every leaf of the reference's tree arrives at its key with its
    shape and values: the f32 router, the 4-D stacked banks (L, E, ., .),
    Arctic's dense branch; the port's init_params builds that layout, its
    router f32 whatever param_dtype."""
    cfg = model["cfg"]
    flat = jax.tree_util.tree_flatten_with_path(model["jparams"])[0]
    for path, leaf in flat:
        node = model["params"]
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    moe = model["params"]["layers"]["moe"]
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    assert moe["router"]["w"].shape == (cfg.n_layers, d, e)
    assert moe["router"]["w"].dtype == torch.float32
    assert moe["w_gate"].shape == moe["w_up"].shape == (cfg.n_layers, e, d, f)
    assert moe["w_down"].shape == (cfg.n_layers, e, f, d)
    assert ("dense" in moe) == (model["arch"] == "arctic-480b")
    if "dense" in moe:
        assert moe["dense"]["w_gate"]["w"].shape == (cfg.n_layers, d, 64)
    mine = M.init_params(dataclasses.replace(cfg, param_dtype="bfloat16"),
                         torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == \
        jax.tree.map(lambda x: x.shape, model["jparams"])
    assert mine["layers"]["moe"]["router"]["w"].dtype == torch.float32
    assert mine["layers"]["moe"]["w_gate"].dtype == torch.bfloat16


def _kinds(tree):
    return {k: _kinds(v) if isinstance(v, dict) else
            str(np.asarray(v).dtype if not isinstance(v, torch.Tensor)
                else v.dtype).replace("torch.", "")
            for k, v in tree.items()}


def test_quantize_params_walks_as_the_reference(model):
    """The same keys quantized as the JAX walk: attention, lm_head and
    Arctic's dense branch; the router and the raw banks stay float."""
    mine = _kinds(M.quantize_params(model["params"]))
    want = _kinds(JM.quantize_params(model["jparams"]))
    assert mine == want
    moe = mine["layers"]["moe"]
    assert moe["router"] == {"w": "float32"} and moe["w_gate"] == "float32"
    if "dense" in moe:
        assert moe["dense"]["w_up"]["w_q"] == "int8"


def test_place_params_keeps_the_router_and_casts_the_banks(model):
    """The engine's placement: the banks in the compute dtype, the router
    in f32 (the reference feeds it f32 activations against f32 weights)."""
    p = place_params(model["params"], torch.device("cpu"), torch.bfloat16)
    moe = p["layers"]["moe"]
    assert moe["router"]["w"].dtype == torch.float32
    for name in ("w_gate", "w_up", "w_down"):
        assert moe[name].dtype == torch.bfloat16, name
    assert p["layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16


def test_batched_plain_versions_match_vmapped_chokepoints():
    """gemm.matmul and gemm.gated_mlp on banks (E, K, N) against the JAX
    chokepoints, which vmap the 2-D Pallas kernels over the experts."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w = rng.standard_normal((3, 16, 24)).astype(np.float32) * 0.25
    u = rng.standard_normal((3, 16, 24)).astype(np.float32) * 0.25
    with PALLAS.scope():
        want_mm = JG.matmul(jnp.asarray(a), jnp.asarray(w))
        want_g = JG.gated_mlp(jnp.asarray(a), jnp.asarray(w), jnp.asarray(u))
    t = [torch.from_numpy(x) for x in (a, w, u)]
    _close(gemm.matmul(t[0], t[1]), want_mm, "matmul", 1e-5)
    _close(gemm.gated_mlp(*t), want_g, "gated_mlp", 1e-5)
    _close(ops.matmul_batched(t[0], t[1]), want_mm, "ops", 1e-5)
    with pytest.raises(ValueError, match="bank"):
        ops.matmul_batched(t[0], t[1][:2])
    with pytest.raises(ValueError, match="dtype"):
        gemm.matmul(t[0], t[1], out_dtype=torch.bfloat16)


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_and_moe_apply_match(arch, dispatch):
    """The router (expert ids, capacity positions, kept assignments equal;
    logits and probabilities) and moe_apply's output and aux against the
    reference's on 2 x 48 tokens (3 groups of 32), assignments dropped."""
    jcfg, cfg = _cfgs(arch, dispatch)
    jp = JMoE.moe_init(jax.random.PRNGKey(1), jcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(2).standard_normal((2, 48, 64)) \
        .astype(np.float32)
    g, s = 3, 32
    assert PMoE.group_size(cfg.moe, 96) == s
    with PALLAS.scope():
        jout, jaux = JMoE.moe_apply(jp, jnp.asarray(x), jcfg)
        jr = JMoE._route(jp, jnp.asarray(x).reshape(g, s, 64), jcfg.moe)
    aux = {}
    out = PMoE.moe_apply(p, torch.from_numpy(x), cfg, aux=aux)
    r = PMoE._route(p, torch.from_numpy(x).reshape(g, s, 64), cfg.moe)
    for i, what in ((3, "top_i"), (4, "pos"), (5, "keep")):
        np.testing.assert_array_equal(r[i].numpy(), np.asarray(jr[i]), what)
    assert r[6] == jr[6]
    for i, what in ((0, "logits"), (1, "probs"), (2, "top_p")):
        _close(r[i], jr[i], what, 1e-6)
    assert not r[5].all(), "expected dropped assignments"
    _close(out, jout, "moe_apply", 1e-6)
    assert set(aux) == set(jaux)
    for k in aux:
        _close(aux[k], jaux[k], k, 1e-6)


def test_ties_go_to_the_lower_expert():
    """With a zero router every probability ties: each token's top-2 are
    experts 0 and 1, as jax.lax.top_k breaks ties."""
    _, cfg = _cfgs("mixtral-8x22b")
    p = {"router": {"w": torch.zeros(64, 4)}}
    r = PMoE._route(p, torch.randn(1, 8, 64), cfg.moe)
    assert r[3].tolist() == [[[0, 1]] * 8]
    # capacity 5: the first five tokens keep both choices, the rest drop
    assert r[6] == 5
    assert r[5][0].tolist() == [[True, True]] * 5 + [[False, False]] * 3


def test_forward_matches(model):
    """Training-shaped logits of a 40-token batch and the aux (router
    losses summed over layers, dropped fraction averaged)."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, T)) \
        .astype(np.int32)
    with PALLAS.scope():
        want, jaux = JM.forward(jcfg, model["jparams"],
                                {"tokens": jnp.asarray(tokens)})
    aux = {}
    got = M.forward(cfg, model["params"],
                    {"tokens": torch.from_numpy(tokens).long()}, aux=aux)
    _close(got, want, "forward")
    assert set(aux) == set(jaux)
    for k in aux:
        _close(aux[k], jaux[k], k, 1e-6)
    assert torch.equal(got, M.forward(cfg, model["params"], {
        "tokens": torch.from_numpy(tokens).long()}))


def _to_pages(cache, quant):
    """A dense cache's rows laid into a page pool of PS rows a page: slot
    b's logical page j at pool page j * B + b."""
    n_layers, b, tmax, hkv, d = cache["k"].shape
    pp = tmax // PS
    table = (torch.arange(pp)[None] * b + torch.arange(b)[:, None]).int()
    pages = {}
    for name in ("k", "v"):
        x = cache[name].reshape(n_layers, b, pp, PS, hkv, d).transpose(1, 2) \
            .reshape(n_layers, pp * b, PS, hkv, d).contiguous()
        if quant:
            qx, s = precision.quantize_kv(x)
            pages[name], pages[name + "s"] = qx, s.transpose(2, 3).contiguous()
        else:
            pages[name] = x
    return {"pages": pages, "table": table}


def _cache_for(layout, model):
    cache = {k: v.clone() for k, v in model["cache"].items()}
    return cache if layout == "dense" else _to_pages(
        cache, layout == "paged-int8")


def _close_caches(got, want):
    got = got["pages"] if "pages" in got else got
    want = want["pages"] if "pages" in want else want
    for name in got:
        g, w = got[name].numpy(), np.asarray(want[name])
        if g.dtype == np.int8:
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, name
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("layout", ["dense", "paged", "paged-int8"])
def test_prefill_then_decode_step_match(model, layout):
    """The prefill's logits and caches (40 tokens, past mixtral's window),
    then one decode step at per-slot positions (slot 1 idle) on the cache
    in `layout`: the active rows' logits and the whole cache."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    _close(model["log"], model["jlog"], "prefill logits")
    _close_caches(model["cache"], model["jcache"])
    cache = _cache_for(layout, model)
    jcache = as_jax(cache)
    tok = np.random.default_rng(4).integers(0, cfg.vocab, (B, 1)) \
        .astype(np.int32)
    pos = np.array([T, -1, T], np.int32)
    with PALLAS.scope():
        jlog, jcache = JM.decode_step(jcfg, model["jparams"], jnp.asarray(tok),
                                      jnp.asarray(pos), jcache)
    log, cache = M.decode_step(cfg, model["params"],
                               torch.from_numpy(tok).long(),
                               torch.from_numpy(pos), cache)
    for s in (0, 2):
        _close(log[s], np.asarray(jlog)[s], f"decode logits, slot {s}")
    _close_caches(cache, jcache)


@pytest.mark.parametrize("layout", ["dense", "paged-int8"])
def test_verify_step_matches(model, layout):
    """A verify step over (pending, 3 proposals) after the prefill, at
    per-slot positions, every row real, the 12 tokens one routing group
    (arctic's capacity of 6 drops some): the logits and the cache."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    cache = _cache_for(layout, model)
    jcache = as_jax(cache)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, 4)) \
        .astype(np.int32)
    with PALLAS.scope():
        jlog, jcache = JM.verify_step(jcfg, model["jparams"],
                                      jnp.asarray(tokens), jnp.asarray(POS),
                                      jnp.asarray(N_TOK), jcache)
    log, cache = M.verify_step(cfg, model["params"],
                               torch.from_numpy(tokens).long(),
                               torch.from_numpy(POS), torch.from_numpy(N_TOK),
                               cache)
    for s in range(B):
        n = int(N_TOK[s])
        _close(log[s, :n], np.asarray(jlog)[s, :n], f"verify rows, slot {s}")
    _close_caches(cache, jcache)


LENGTHS = [36, 12, 34, 9]            # two past the window; buckets 32 and 8
GENS = [4, 3, 4, 2]
ENGINES = {"dense": ({}, {}),
           "paged": (dict(kv_layout="paged"), {}),
           "int8-weights-int8-pool": (dict(kv_layout="paged",
                                           quant_kv="int8", quant="int8"),
                                      {})}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_streams_match_jax_engine(engine):
    """mixtral (reduced, f32) served by both engines on 2 slots, pages of
    8: the same greedy streams, token for token, on a dense cache, a bf16
    pool and with int8 weights on an int8 pool; a mid-stream admission."""
    jcfg, cfg = _cfgs("mixtral-8x22b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in LENGTHS]
    kw, _ = ENGINES[engine]
    pol = PALLAS.replace(kv_layout=kw.get("kv_layout", "dense"),
                         quant_kv=kw.get("quant_kv", "off"),
                         quant=kw.get("quant", "off"))

    def run(eng):
        reqs = [eng.submit(p, g) for p, g in zip(prompts, GENS)]
        assert eng.run()["n_finished"] == len(reqs)
        assert sorted(r.t_admitted for r in reqs)[-1] > \
            sorted(r.t_finished for r in reqs)[0], "a mid-stream admission"
        return [r.generated for r in reqs]

    want = run(JaxEngine(jcfg, jparams, max_slots=2, max_len=64, page_size=8,
                         policy=pol))
    got = run(ServingEngine(cfg, params, max_slots=2, max_len=64,
                            page_size=8, device="cpu", **kw))
    assert got == want


def test_moe_refuses_what_it_does_not_serve_yet():
    """A moe target takes a draft (tests/test_torch_moe_spec.py), but not
    an encdec one (its draft steps carry no encoder cache) nor a draft of
    another vocab: both are refused at construction, not run."""
    _, cfg = _cfgs("mixtral-8x22b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    wcfg = get_config("whisper-tiny", reduced=True)
    wparams = M.init_params(wcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="encdec"):
        ServingEngine(cfg, params, max_slots=2, max_len=32, device="cpu",
                      draft=(wcfg, wparams))
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(cfg, params, max_slots=2, max_len=32, device="cpu",
                      draft=(dataclasses.replace(cfg, vocab=cfg.vocab // 2),
                             params))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_reduced(arch, capsys):
    report = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--requests", "3", "--max-slots", "2",
                         "--prompt-len-min", "8", "--prompt-len-max", "40",
                         "--gen", "3"])
    assert report["n_finished"] == 3
    assert f"arch={arch}-reduced" in capsys.readouterr().out
