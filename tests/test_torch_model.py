"""The port's qwen3 model (reduced) against the JAX package's under
`Policy(backend="pallas", interpret=True)`, on the same weights (the JAX
params, bridged leaf for leaf) and the same numpy inputs.

Both sides run in float32 (bf16 rounds at other places in XLA and in
PyTorch). Stated tolerance: atol = 1e-4 on logits and caches.
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
from repro_torch.models import attention as A
from repro_torch.models import model as M

ATOL = 1e-4
PALLAS = Policy(backend="pallas", interpret=True)
B, S, MAX_LEN = 2, 8, 16


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    with PALLAS.scope():
        jlog, jcache = JM.prefill(jcfg, jparams, {"tokens": jnp.asarray(tokens)},
                                  JM.init_cache(jcfg, B, MAX_LEN))
    cache = M.init_cache(cfg, B, MAX_LEN, "cpu")
    log, cache = M.prefill(cfg, params, {"tokens": torch.from_numpy(tokens).long()},
                           cache)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                jlog=jlog, jcache=jcache, log=log, cache=cache)


def _close_caches(cache, jcache):
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=ATOL, rtol=0)


def test_config_matches_reference():
    for reduced in (False, True):
        a = dataclasses.asdict(get_config("qwen3-0.6b", reduced=reduced))
        b = dataclasses.asdict(jax_get_config("qwen3-0.6b", reduced=reduced))
        assert a == {k: v for k, v in b.items() if k in a}
    assert get_config("qwen3-0.6b").padded_vocab == 152064


def test_bridge_keeps_keys_and_shapes(setup):
    flat_j = jax.tree_util.tree_flatten_with_path(setup["jparams"])[0]
    for path, leaf in flat_j:
        node = setup["params"]
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32


def test_init_params_matches_reference_layout():
    cfg = get_config("qwen3-0.6b", reduced=True)
    jcfg = jax_get_config("qwen3-0.6b", reduced=True)
    mine = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    shapes = jax.tree.map(lambda x: (x.shape, str(x.dtype)), ref)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                        mine) == shapes


def test_prefill_logits_and_cache_match(setup):
    np.testing.assert_allclose(setup["log"].numpy(), np.asarray(setup["jlog"]),
                               atol=ATOL, rtol=0)
    _close_caches(setup["cache"], setup["jcache"])


@pytest.mark.parametrize("pos", ["scalar", "vector"])
def test_decode_step_matches(setup, pos):
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    tok = np.array([[3], [7]], np.int32)
    jpos = jnp.int32(S) if pos == "scalar" else jnp.asarray([S, -1], jnp.int32)
    tpos = S if pos == "scalar" else torch.tensor([S, -1], dtype=torch.int32)
    with PALLAS.scope():
        jlog, jcache = JM.decode_step(jcfg, setup["jparams"], jnp.asarray(tok),
                                      jpos, setup["jcache"])
    cache = {k: v.clone() for k, v in setup["cache"].items()}
    log, cache = M.decode_step(cfg, setup["params"], torch.from_numpy(tok).long(),
                               tpos, cache)
    if pos == "vector":      # slot 1 is idle: its logits are garbage
        log, jlog = log[:1], jlog[:1]
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=ATOL, rtol=0)
    _close_caches(cache, jcache)


def test_inactive_slot_leaves_cache_untouched(setup):
    old = {k: v.clone() for k, v in setup["cache"].items()}
    cache = {k: v.clone() for k, v in setup["cache"].items()}
    tok = torch.zeros((B, 1), dtype=torch.long)
    M.decode_step(setup["cfg"], setup["params"], tok,
                  torch.tensor([S, -1], dtype=torch.int32), cache)
    for name in ("k", "v"):
        assert torch.equal(cache[name][:, 1], old[name][:, 1])
        assert not torch.equal(cache[name][:, 0], old[name][:, 0])


def test_vector_pos_uniform_batch_matches_scalar(setup):
    """All slots at one depth: the per-slot path equals the scalar path
    bit for bit."""
    tok = torch.tensor([[3], [7]])
    c_s = {k: v.clone() for k, v in setup["cache"].items()}
    c_v = {k: v.clone() for k, v in setup["cache"].items()}
    lg_s, c_s = M.decode_step(setup["cfg"], setup["params"], tok, S, c_s)
    lg_v, c_v = M.decode_step(setup["cfg"], setup["params"], tok,
                              torch.full((B,), S, dtype=torch.int32), c_v)
    assert torch.equal(lg_s, lg_v)
    for name in ("k", "v"):
        assert torch.equal(c_s[name], c_v[name])


def test_padded_vocab_is_masked():
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              vocab=250, dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = M.init_cache(cfg, 1, 8, "cpu")
    log, _ = M.prefill(cfg, params, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                       cache)
    assert log.shape == (1, 1, 256) and log.dtype == torch.float32
    assert (log[..., 250:] == -1e30).all() and (log[..., :250] > -1e29).all()


def test_cache_write_skips_idle_slots_and_drops_rows_past_the_end():
    """Per slot: pos < 0 (idle) and pos >= Tmax write nothing, as the
    JAX package's scatter with mode="drop" writes nothing."""
    cache = {n: torch.zeros(3, 4, 2, 8) for n in ("k", "v")}
    new = torch.ones(3, 1, 2, 8)
    A._write_rows(cache, new, 2 * new, torch.tensor([-1, 1, 4]))
    for name, val in (("k", 1.0), ("v", 2.0)):
        want = torch.zeros(3, 4, 2, 8)
        want[1, 1] = val
        assert torch.equal(cache[name], want)


def test_per_slot_pos_takes_one_token_a_slot(setup):
    """Two tokens a slot at a per-slot position are two one-token steps:
    token r of slot 0 lands at S + r, its cache rows those of the
    one-token step at S + r bit for bit, and its logits row that step's
    to within f32 rounding (on the CPU the tied logits GEMM, a transposed
    operand, takes another kernel at 2 rows than at 4); the idle slot
    (pos -1) writes nothing."""
    cfg, params = setup["cfg"], setup["params"]
    cache = {k: v.clone() for k, v in setup["cache"].items()}
    steps = {k: v.clone() for k, v in setup["cache"].items()}
    toks = torch.tensor([[3, 5], [7, 9]], dtype=torch.long)
    got, _ = M.decode_step(cfg, params, toks,
                           torch.tensor([S, -1], dtype=torch.int32), cache)
    for r in range(2):
        want, _ = M.decode_step(cfg, params, toks[:, r:r + 1],
                                torch.tensor([S + r, -1], dtype=torch.int32),
                                steps)
        torch.testing.assert_close(got[0, r], want[0, 0], atol=1e-5,
                                   rtol=0)
    for name in cache:
        assert torch.equal(cache[name], steps[name]), name
        assert torch.equal(cache[name][:, 1], setup["cache"][name][:, 1])


# ----------------------------------------------------------------------
# batch["positions"]: RoPE at the given positions, the cache at pos
# ----------------------------------------------------------------------

def _run(pkg, fn, setup, batch):
    """forward's logits, or prefill's logits and cache, of `batch` in the
    JAX package (pkg "jax", under the pallas policy) or the port."""
    if pkg == "jax":
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with PALLAS.scope():
            if fn == "forward":
                return JM.forward(setup["jcfg"], setup["jparams"], jb)[0], None
            return JM.prefill(setup["jcfg"], setup["jparams"], jb,
                              JM.init_cache(setup["jcfg"], B, MAX_LEN))
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    if fn == "forward":
        return M.forward(setup["cfg"], setup["params"], tb), None
    return M.prefill(setup["cfg"], setup["params"], tb,
                     M.init_cache(setup["cfg"], B, MAX_LEN, "cpu"))


@pytest.mark.parametrize("fn", ["forward", "prefill"])
def test_shifted_positions_match_reference(setup, fn):
    """A batch whose (B, S) positions are shifted and differ per row (row
    0 from 5, row 1 from 11, each with a gap of 3 after its fourth token,
    so that distances change too): q and k turn by them in both packages,
    and the prefill writes the cache at pos 0 all the same. Logits (and
    the cache) within atol 1e-4, and not the default positions' logits."""
    tokens = np.random.default_rng(7).integers(0, setup["cfg"].vocab, (B, S)) \
        .astype(np.int32)
    gap = np.where(np.arange(S) >= 4, 3, 0)
    positions = (np.arange(S)[None] + gap + np.array([[5], [11]])) \
        .astype(np.int32)
    batch = {"tokens": tokens, "positions": positions}
    got, cache = _run("torch", fn, setup, batch)
    want, jcache = _run("jax", fn, setup, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    if fn == "prefill":
        _close_caches(cache, jcache)
    default, _ = _run("torch", fn, setup, {"tokens": tokens})
    assert (got - default).abs().max() > 1e-3


@pytest.mark.parametrize("fn", ["forward", "prefill"])
def test_default_positions_keep_the_bits(setup, fn):
    """Without a positions key, a token turns by its place (from pos 0):
    the logits and cache of the batch with those positions given, bit for
    bit."""
    tokens = np.random.default_rng(8).integers(0, setup["cfg"].vocab, (B, S)) \
        .astype(np.int32)
    given = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    a, ca = _run("torch", fn, setup, {"tokens": tokens})
    b, cb = _run("torch", fn, setup, {"tokens": tokens, "positions": given})
    assert torch.equal(a, b)
    if fn == "prefill":
        for name in ("k", "v"):
            assert torch.equal(ca[name], cb[name]), name
