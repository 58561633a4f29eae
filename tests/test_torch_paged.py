"""The port's paged KV cache against the JAX package's: the paged decode
kernel's plain version, the page pool's bookkeeping, a paged decode
step of the reduced qwen3 model (float32 and int8 pages), and the
serving engine over an int8 page pool with prefix sharing and
copy-on-write.

Both sides run in float32 on the same numpy inputs; the JAX side under
`Policy(backend="pallas", interpret=True)`. Tolerances: the decode
kernel's plain version atol = rtol = 1e-5 (the same function, sums in
another order); logits atol = 1e-4; int8 pool entries within 1 and their
scales at rtol = 1e-5 (a scale is the max over an f32 row whose sums
may round differently, so an int8 value can land one step away); the
engine's greedy streams token for token, over one round of requests and
over two (the second on the first's buffers), and its page table
tensor synced in place, the one a captured decode step reads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.policy import Policy
from repro.kernels import ops as jops
from repro.models import model as JM
from repro.serving import ServingEngine as JaxEngine
from repro.serving.kv_pool import KVPagePool as JaxPool
from repro.serving.kv_pool import KVPoolExhausted as JaxExhausted
from repro.serving.workload import prefix_heavy_trace as jax_prefix_trace
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.serving import (KVPagePool, KVPoolExhausted, ServingEngine,
                                 prefix_heavy_trace)

TOL = dict(atol=1e-5, rtol=1e-5)
ATOL = 1e-4
PALLAS = Policy(backend="pallas", interpret=True)


def _configs():
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              dtype="float32")
    return jcfg, cfg


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = _configs()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params)


def _table(rng, pos, ps, pp, n_pages, mapped_extra=()):
    """Shuffled physical pages for each slot's pages [0, pos // ps], -1
    past them (and for an idle slot); `mapped_extra` (slot, n) maps n
    pages of an idle slot."""
    perm = rng.permutation(n_pages)
    table = np.full((len(pos), pp), -1, np.int32)
    nxt = 0
    extra = dict(mapped_extra)
    for b, p in enumerate(pos):
        n = p // ps + 1 if p >= 0 else extra.get(b, 0)
        table[b, :n] = perm[nxt:nxt + n]
        nxt += n
    return table


def _pool(rng, shape, int8):
    """A pool (k, v[, ks, vs]) of random numpy pages [P, ps, Hkv, D]."""
    if not int8:
        return [rng.standard_normal(shape).astype(np.float32)
                for _ in range(2)]
    n_pages, ps, hkv, _ = shape
    q = [rng.integers(-127, 128, shape).astype(np.int8) for _ in range(2)]
    s = [(rng.random((n_pages, hkv, ps)) * 0.02 + 1e-3).astype(np.float32)
         for _ in range(2)]
    return q + s


# ----------------------------------------------------------------------
# the kernel's plain version
# ----------------------------------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [None, 5])
def test_flash_decode_paged_matches_pallas(int8, window):
    rng = np.random.default_rng(0)
    b, h, hkv, d, ps, pp = 4, 4, 2, 16, 4, 6
    n_pages = 28
    pos = np.array([-1, 0, 11, pp * ps - 1], np.int32)
    table = _table(rng, pos, ps, pp, n_pages)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    pool = _pool(rng, (n_pages, ps, hkv, d), int8)
    names = ("kp", "vp", "ks", "vs")
    want = jops.flash_decode_paged(
        jnp.asarray(q), *map(jnp.asarray, pool[:2]), jnp.asarray(table),
        pos=jnp.asarray(pos), window=window, policy=PALLAS,
        **{n: jnp.asarray(x) for n, x in zip(names[2:], pool[2:])})
    t = torch.from_numpy
    got = ops.flash_decode_paged(
        t(q), *map(t, pool[:2]), t(table), pos=t(pos), window=window,
        **{n: t(x) for n, x in zip(names[2:], pool[2:])})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[0].any(), "an idle slot (pos < 0) must give zeros"


def test_flash_decode_paged_refuses_bad_operands():
    q = torch.zeros(1, 1, 2, 8)
    kp = torch.zeros(3, 4, 1, 8)
    table = torch.zeros(1, 2, dtype=torch.int32)
    s = torch.ones(3, 1, 4)
    with pytest.raises(ValueError, match="n_valid"):
        ops.flash_decode_paged(torch.zeros(1, 2, 2, 8), kp, kp, table,
                               n_valid=torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="int8 pool"):
        ops.flash_decode_paged(q, kp, kp, table, ks=s, vs=s)
    with pytest.raises(ValueError, match="int8 pool"):
        ops.flash_decode_paged(q, kp.to(torch.int8), kp.to(torch.int8), table)
    with pytest.raises(ValueError, match="go together"):
        ops.flash_decode_paged(q, kp.to(torch.int8), kp.to(torch.int8), table,
                               ks=s)


# ----------------------------------------------------------------------
# the page pool's bookkeeping
# ----------------------------------------------------------------------

def _same_pool(mine, ref):
    np.testing.assert_array_equal(mine.table, ref.table)
    np.testing.assert_array_equal(mine.refcount, ref.refcount)
    assert mine.report() == ref.report()
    assert mine.version == ref.version


def test_pool_bookkeeping_matches_reference():
    """The same admit / prepare_write / release sequence, with a shared
    prefix, a partial shared tail page, a copy-on-write and an
    exhaustion refusal, gives equal plans, tables, refcounts and
    reports."""
    pools = (KVPagePool(10, 4, 3, 6), JaxPool(10, 4, 3, 6))
    errors = (KVPoolExhausted, JaxExhausted)
    a = np.arange(10, dtype=np.int32)
    b = np.concatenate([a[:8], [77, 78, 79]]).astype(np.int32)
    steps = [("admit", 0, a, 5), ("admit", 1, a, 5),
             ("write", 0, 10), ("write", 1, 10), ("write", 0, 12),
             ("write", 1, 11), ("can", np.arange(20), 3),
             ("admit", 2, np.arange(20, dtype=np.int32), 3),
             ("admit", 2, b, 2), ("release", 0), ("release", 2),
             ("admit", 0, np.arange(20, dtype=np.int32), 3),
             ("write", 0, 20), ("release", 1)]
    for step in steps:
        outs = []
        for pool, err in zip(pools, errors):
            kind, *args = step
            try:
                if kind == "admit":
                    out = dataclasses.astuple(pool.admit_slot(*args))
                elif kind == "write":
                    w = pool.prepare_write(*args)
                    out = None if w is None else dataclasses.astuple(w)
                elif kind == "can":
                    out = pool.can_admit(*args)
                else:
                    out = pool.release_slot(*args)
            except err as e:
                out = ("refused", type(e).__name__)
            outs.append(out)
        assert outs[0] == outs[1], step
        _same_pool(*pools)
    r = pools[0].report()
    assert r["shared_page_hits"] > 0 and r["cow_copies"] > 0 \
        and r["refused"] > 0


# ----------------------------------------------------------------------
# a paged decode step of the model
# ----------------------------------------------------------------------

@pytest.mark.parametrize("quant_kv", ["off", "int8"])
def test_paged_decode_step_matches_reference(model, quant_kv):
    """Slots: idle with mapped pages (untouched), at depths 5, 13 and 20,
    and one whose write page is unmapped (its write is dropped)."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    rng = np.random.default_rng(1)
    ps, pp, n_pages = 4, 6, 30
    pos = np.array([-1, 5, 13, 20, 9], np.int32)
    table = _table(rng, pos, ps, pp, n_pages, mapped_extra=[(0, 3)])
    table[4, 9 // ps] = -1
    ref_cache = M.init_paged_cache(cfg, n_pages, ps, len(pos), pp,
                                   quant_kv=quant_kv, device="cpu")
    shape = tuple(ref_cache["pages"]["k"].shape)
    layers = [_pool(rng, shape[1:], quant_kv == "int8")
              for _ in range(cfg.n_layers)]
    names = ("k", "v", "ks", "vs")
    pages = {n: np.stack([lay[i] for lay in layers])
             for i, n in enumerate(names[:len(layers[0])])}
    tok = rng.integers(0, cfg.vocab, (len(pos), 1)).astype(np.int32)

    jcache = {"pages": {n: jnp.asarray(x) for n, x in pages.items()},
              "table": jnp.asarray(table)}
    with PALLAS.scope():
        jlog, jcache = JM.decode_step(jcfg, model["jparams"], jnp.asarray(tok),
                                      jnp.asarray(pos), jcache)
    cache = {"pages": {n: torch.from_numpy(x.copy()) for n, x in pages.items()},
             "table": torch.from_numpy(table)}
    log, cache = M.decode_step(cfg, model["params"], torch.from_numpy(tok).long(),
                               torch.from_numpy(pos), cache)

    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=ATOL, rtol=0)
    for n, want in jcache["pages"].items():
        got, want = cache["pages"][n].numpy(), np.asarray(want)
        if n in ("ks", "vs"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
        elif quant_kv == "int8":
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        # the idle slot's and the dropped write's pages are untouched
        for b in (0, 4):
            for phys in table[b][table[b] >= 0]:
                assert np.array_equal(got[:, phys], pages[n][:, phys]), (n, b)


def test_page_write_drops_idle_unmapped_and_past_the_table():
    """Per slot: pos < 0, an unmapped write page and a position past the
    table write nothing; the others land at (table[b, pos // ps],
    pos % ps), whatever the order of the slots."""
    pool = {n: torch.zeros(5, 2, 1, 3) for n in ("k", "v")}
    table = torch.tensor([[0, -1], [1, 2], [3, 4], [-1, -1]], dtype=torch.int32)
    k = torch.arange(1, 5, dtype=torch.float32)[:, None, None, None] \
        .expand(4, 1, 1, 3)
    A._write_pages(pool, table, k, -k, torch.tensor([2, 3, 4, -1]))
    want = torch.zeros(5, 2, 1, 3)
    want[2, 1] = 2.0                      # slot 1 at pos 3: page 2, row 1
    assert torch.equal(pool["k"], want) and torch.equal(pool["v"], -want)


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------

def test_prefix_heavy_trace_matches_jax_trace():
    jcfg, cfg = _configs()
    kw = dict(prefix_len=9, suffix_range=(0, 5), gen=3)
    mine = prefix_heavy_trace(cfg, 5, rng=np.random.default_rng(4), **kw)
    ref = jax_prefix_trace(jcfg, 5, rng=np.random.default_rng(4), **kw)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.gen, a.arrival) == (b.gen, b.arrival)


def _run(engine, trace):
    reqs = [engine.submit(it.prompt, it.gen) for it in trace]
    report = engine.run()
    assert report["n_finished"] == len(reqs)
    return [r.generated for r in reqs], report


def test_engine_paged_int8_kv_streams_match_jax_engine(model):
    """Four identical 13-token prompts (the tail page is partial and
    shared) over 2 slots and 8-token pages: every first decode write
    hits a shared page and is copied on write."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    trace = prefix_heavy_trace(cfg, 4, rng=np.random.default_rng(5),
                               prefix_len=13, suffix_range=(0, 0), gen=4)
    jeng = JaxEngine(jcfg, model["jparams"], max_slots=2, max_len=24,
                     page_size=8,
                     policy=Policy(backend="pallas", interpret=True,
                                   kv_layout="paged", quant_kv="int8"))
    want, jrep = _run(jeng, trace)
    eng = ServingEngine(cfg, model["params"], max_slots=2, max_len=24,
                        device="cpu", kv_layout="paged", quant_kv="int8",
                        page_size=8)
    got, rep = _run(eng, trace)
    assert got == want
    for r in (rep["kv_pool"], jrep["kv_pool"]):
        assert r["shared_page_hits"] > 0 and r["cow_copies"] > 0
    assert rep["kv_pool"] == jrep["kv_pool"]


def test_engine_refuses_bad_layouts_and_oversized_requests(model):
    cfg = model["cfg"]
    with pytest.raises(ValueError, match="kv_layout='paged'"):
        ServingEngine(cfg, model["params"], max_slots=1, max_len=16,
                      device="cpu", quant_kv="int8")
    with pytest.raises(ValueError, match="kv_layout"):
        ServingEngine(cfg, model["params"], max_slots=1, max_len=16,
                      device="cpu", kv_layout="ragged")
    eng = ServingEngine(cfg, model["params"], max_slots=3, max_len=64,
                        device="cpu", kv_layout="paged", page_size=8,
                        kv_pool_pages=6)
    with pytest.raises(KVPoolExhausted):
        eng.submit(np.arange(50, dtype=np.int32) % cfg.vocab, 10)
    # 5 prompt pages and a 2-page write range whose first page is the
    # partial prompt tail: 6 pages of tokens, but admission needs 7
    with pytest.raises(KVPoolExhausted):
        eng.submit(np.arange(36, dtype=np.int32), 10)
    assert eng.pool.can_admit(np.arange(36), 4)
    eng.submit(np.arange(36, dtype=np.int32), 4)


def test_engine_full_pool_defers_admission(model):
    """Three requests whose pages exceed a 6-page pool: the third waits
    for a release though a slot is free the whole time, and every
    stream equals the dense engine's."""
    cfg = model["cfg"]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, (24,)).astype(np.int32)
               for _ in range(3)]
    eng = ServingEngine(cfg, model["params"], max_slots=3, max_len=64,
                        device="cpu", kv_layout="paged", page_size=8,
                        kv_pool_pages=6)
    reqs = [eng.submit(p, 6) for p in prompts]
    assert eng.run()["n_finished"] == 3
    admitted = sorted(r.t_admitted for r in reqs)
    finished = sorted(r.t_finished for r in reqs)
    assert admitted[-1] > finished[0], "expected a pool-deferred admission"
    dense = ServingEngine(cfg, model["params"], max_slots=3, max_len=64,
                          device="cpu")
    want = [dense.submit(p, 6) for p in prompts]
    dense.run()
    assert [r.generated for r in reqs] == [r.generated for r in want]


def test_serve_cli_paged_int8_smoke(capsys):
    out = serve.main(["--reduced", "--device", "cpu", "--requests", "4",
                      "--max-slots", "2", "--kv-layout", "paged",
                      "--quant-kv", "int8", "--page-size", "8",
                      "--prefix-len", "16"])
    text = capsys.readouterr().out
    assert "kv pool:" in text and out["n_finished"] == 4
    assert out["kv_pool"]["shared_page_hits"] > 0


def test_engine_paged_int8_serves_two_rounds_as_the_jax_engine(model):
    """int8 pages and int8 weights, 2 slots, 8-token pages: one engine
    serves a round of requests sharing a 13-token prefix (copy-on-write
    of the shared tail page), then, once it has drained, a second round
    sharing another prefix, remainder tokens in both; each round's
    streams and the pool's report equal one JAX engine's over the same
    two rounds."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    rounds = [prefix_heavy_trace(cfg, 4, rng=np.random.default_rng(seed),
                                 prefix_len=n, suffix_range=(0, 3), gen=4)
              for seed, n in ((5, 13), (8, 11))]

    def serve(engine):
        out = []
        for trace in rounds:
            reqs = [engine.submit(it.prompt, it.gen) for it in trace]
            engine.run()
            assert all(len(r.generated) == r.max_new_tokens for r in reqs)
            out.append([r.generated for r in reqs])
        return out, engine.pool.report()

    want = serve(JaxEngine(jcfg, model["jparams"], max_slots=2, max_len=24,
                           page_size=8,
                           policy=Policy(backend="pallas", interpret=True,
                                         kv_layout="paged", quant_kv="int8",
                                         quant="int8")))
    got = serve(ServingEngine(cfg, model["params"], max_slots=2, max_len=24,
                              device="cpu", kv_layout="paged",
                              quant_kv="int8", quant="int8", page_size=8))
    assert got == want
    assert got[1]["cow_copies"] > 0 and got[1]["shared_page_hits"] > 0


def test_page_table_is_synced_in_place(model):
    """The cache's table tensor keeps its storage across admissions,
    copy-on-write and releases, and equals the pool's host table at
    every decode step."""
    cfg = model["cfg"]
    trace = prefix_heavy_trace(cfg, 5, rng=np.random.default_rng(6),
                               prefix_len=13, suffix_range=(0, 0), gen=5)
    eng = ServingEngine(cfg, model["params"], max_slots=2, max_len=24,
                        device="cpu", kv_layout="paged", page_size=8)
    table = eng.cache["table"]
    ptr, step, versions = table.data_ptr(), eng._step, []

    def checked():
        assert eng.cache["table"] is table and table.data_ptr() == ptr
        np.testing.assert_array_equal(table.numpy(), eng.pool.table)
        versions.append(eng.pool.version)
        return step()
    eng._step = checked
    _run(eng, trace)
    rep = eng.pool.report()
    assert rep["cow_copies"] > 0 and rep["shared_page_hits"] > 0, rep
    assert len(set(versions)) > 2, versions   # the table changed between steps
