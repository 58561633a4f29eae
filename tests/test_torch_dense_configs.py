"""The dense configs the dense path covers, granite-3-8b, granite-20b (one
KV head: MQA) and qwen1.5-32b (as many KV heads as query heads: MHA; QKV
biases), and the vlm qwen2-vl-2b (QKV biases, M-RoPE, patch embeddings),
at their reduced sizes, against the JAX package on the same weights (the
JAX params, bridged leaf for leaf) and the same numpy inputs: the
configs, the bridged trees, `forward`, `prefill` then `decode_step` on a
dense cache and on bf16-layout and int8 page pools, and `verify_step`.

Both sides in float32; the JAX side under `Policy(backend="pallas",
interpret=True)`. Both packages start the QKV biases at zeros, so the
biases are drawn from a seed in the JAX tree before it is bridged: the
bias epilogue then carries values. A vlm prompt is multimodal (text, a
4 x 4 image's patch embeddings at their (t, h, w) positions, text); its
decode and verify steps take text positions t = h = w = pos. Tolerance:
atol 1e-4 on logits and caches; int8 pages within one quantization step.
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
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import precision
from repro_torch.data.pipeline import multimodal_prompt
from repro_torch.models import model as M

ATOL = 1e-4
PALLAS = Policy(backend="pallas", interpret=True)
ARCHS = ("granite-3-8b", "granite-20b", "qwen1.5-32b", "qwen2-vl-2b")
B, MAX_LEN, PS = 3, 48, 8
POS = np.array([24, -1, 26], np.int32)          # slot 1 idle
N_TOK = np.array([4, 0, 2], np.int32)


def random_biases(jparams, seed):
    """The JAX tree with every "b" leaf (the QKV biases) drawn from a
    normal of scale 0.1, seeded."""
    rng = np.random.default_rng(seed)

    def rec(node):
        return {k: (jnp.asarray(rng.standard_normal(v.shape) * 0.1, v.dtype)
                    if k == "b" else rec(v) if isinstance(v, dict) else v)
                for k, v in node.items()}
    return rec(jparams)


def prompt(cfg, rng, batch):
    """The prompt batch, numpy: multimodal for vlm (16 patches between two
    runs of 4 text tokens: 24 tokens), else 24 text tokens."""
    if cfg.family == "vlm":
        return multimodal_prompt(rng, cfg.vocab, cfg.d_model, batch=batch,
                                 before=4, grid=(4, 4), after=4)
    return {"tokens": rng.integers(0, cfg.vocab, (batch, 24)).astype(np.int32)}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
    jparams = random_biases(JM.init_params(jcfg, jax.random.PRNGKey(0)), 1)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    m = dict(arch=arch, jcfg=jcfg, cfg=cfg, jparams=jparams, params=params)
    # both packages' batch-B prefill of the prompt into dense caches
    batch = prompt(cfg, np.random.default_rng(3), B)
    with PALLAS.scope():
        m["jlog"], m["jcache"] = JM.prefill(jcfg, jparams, as_jax(batch),
                                            JM.init_cache(jcfg, B, MAX_LEN))
    m["log"], m["cache"] = M.prefill(cfg, params, as_torch(batch),
                                     M.init_cache(cfg, B, MAX_LEN, "cpu"))
    return m


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=0, err_msg=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    for reduced in (False, True):
        a = dataclasses.asdict(get_config(arch, reduced=reduced))
        b = dataclasses.asdict(jax_get_config(arch, reduced=reduced))
        assert a == {k: v for k, v in b.items() if k in a}, (arch, reduced)
        assert set(b) - set(a) <= {"moe", "n_enc_layers", "enc_ctx",
                                   "shard_attn_seq", "constrain_mode",
                                   "scan_layers", "max_position"}


def test_bridge_keeps_keys_shapes_and_biases(model):
    """Every leaf of the reference's tree, the QKV biases among them,
    arrives at the same key with its shape; the port's own init_params
    builds that tree's layout."""
    cfg = model["cfg"]
    flat = jax.tree_util.tree_flatten_with_path(model["jparams"])[0]
    for path, leaf in flat:
        node = model["params"]
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    attn = model["params"]["layers"]["attn"]
    for name in ("wq", "wk", "wv"):
        assert ("b" in attn[name]) == cfg.qkv_bias, name
    mine = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == \
        jax.tree.map(lambda x: x.shape, model["jparams"])


def test_forward_matches(model):
    """Training-shaped logits of a 24-token batch (for vlm multimodal:
    patch embeddings and (B, T, 3) positions)."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    batch = prompt(cfg, np.random.default_rng(2), 2)
    with PALLAS.scope():
        want, _ = JM.forward(jcfg, model["jparams"], as_jax(batch))
    got = M.forward(cfg, model["params"], as_torch(batch))
    _close(got, want, "forward")


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
    """A copy of the port's prefilled cache in `layout`."""
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
    """The prefill's logits and caches, then one decode step at per-slot
    positions (slot 1 idle) on the cache in `layout`: the active rows'
    logits and the whole cache."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    _close(model["log"], model["jlog"], "prefill logits")
    _close_caches(model["cache"], model["jcache"])
    cache = _cache_for(layout, model)
    jcache = jax.tree.map(lambda x: jnp.asarray(x.numpy()), cache)
    tok = np.random.default_rng(4).integers(0, cfg.vocab, (B, 1)) \
        .astype(np.int32)
    pos = np.array([24, -1, 24], np.int32)
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
    per-slot positions with 4, 0 (idle) and 2 real tokens: the real rows'
    logits and the cache."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    cache = _cache_for(layout, model)
    jcache = jax.tree.map(lambda x: jnp.asarray(x.numpy()), cache)
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
