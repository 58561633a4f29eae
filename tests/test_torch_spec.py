"""Speculative decoding in the port against the JAX package: the verify
step's logits and cache rows on dense, bf16-layout and int8 page caches,
the multi-row decode attention's rows against the one-row form, and the
spec engine's streams and acceptance counts against the port's non-spec
engine and the JAX spec engine, with a self-draft and a draft of other
weights. The target cache after a speculative run holds the non-spec
run's rows bit for bit, where the JAX engine's verify rows differ from
its decode rows (`tests/test_spec.py::test_spec_target_cache_matches_
nonspec_rows` holds it only to a tolerance, and fails).

Float32 reduced qwen3 for both packages, the JAX package's weights
bridged into the port; the JAX side under
`Policy(backend="pallas", interpret=True)`. Tolerance atol 1e-4 where
the two packages meet, bits where the port meets itself. The engines
run 2 slots: on the CPU a one-row GEMM takes another kernel than one of
2 rows or more, so a decode step at 2 rows and a verify step at 2 (k+1)
rows write the same K/V bits here, as the card's GEMMs do at any row
count.
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
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import precision
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from repro_torch.serving import ServingEngine, SpecDecoder

ATOL = 1e-4
PALLAS = Policy(backend="pallas", interpret=True)
LENGTHS = [8, 24, 13, 40]
GENS = [5, 4, 7, 6]


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
    jdraft = JM.init_params(jcfg, jax.random.PRNGKey(1))
    conv = lambda p: params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    prompts = [np.random.default_rng(42).integers(0, cfg.vocab, (n,))
               .astype(np.int32) for n in LENGTHS]
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=conv(jparams),
                jdraft=jdraft, draft=conv(jdraft), prompts=prompts)


# ----------------------------------------------------------------------
# the multi-row decode attention (the plain version on the CPU)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged-int8"])
@pytest.mark.parametrize("window", [None, 5])
def test_rows_equal_the_one_row_form_at_their_positions(layout, window):
    """Row r of a slot at pos is the one-row result at pos + r, bit for
    bit; rows past n_valid and an idle slot's rows are zeros."""
    g = torch.Generator().manual_seed(0)
    b, t, h, hkv, d, tk, ps = 3, 5, 4, 2, 16, 32, 8
    q = torch.randn(b, t, h, d, generator=g)
    k = torch.randn(b, tk, hkv, d, generator=g)
    v = torch.randn(b, tk, hkv, d, generator=g)
    pos = torch.tensor([3, 27, -1], dtype=torch.int32)
    n_valid = torch.tensor([5, 3, 5], dtype=torch.int32)
    if layout == "dense":
        def run(qq, p, nv=None):
            return ops.flash_decode(qq, k, v, pos=p, window=window, n_valid=nv)
    else:
        table = torch.arange(b * tk // ps, dtype=torch.int32).reshape(b, -1)
        (kp, ks), (vp, vs) = (precision.quantize_kv(x.reshape(-1, ps, hkv, d))
                              for x in (k, v))
        kw = dict(ks=ks.transpose(1, 2).contiguous(),
                  vs=vs.transpose(1, 2).contiguous())

        def run(qq, p, nv=None):
            return ops.flash_decode_paged(qq, kp, vp, table, pos=p,
                                          window=window, n_valid=nv, **kw)
    got = run(q, pos, n_valid)
    assert got.shape == q.shape
    for r in range(t):
        one = run(q[:, r:r + 1].contiguous(),
                  torch.where(pos >= 0, pos + r, -1).to(torch.int32))
        for s in range(b):
            if pos[s] >= 0 and r < n_valid[s]:
                assert torch.equal(got[s, r], one[s, 0]), (s, r)
            else:
                assert not got[s, r].any(), (s, r)


def test_rows_match_the_masked_softmax():
    """The multi-row form against a plain masked softmax over the keys
    each row sees, in float64."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 4, 4, 16, generator=g)
    k = torch.randn(2, 20, 2, 16, generator=g)
    v = torch.randn(2, 20, 2, 16, generator=g)
    pos = torch.tensor([2, 9])
    got = ref.decode_rows_ref(q, k, v, pos=pos)
    for s in range(2):
        for r in range(4):
            n = int(pos[s]) + r + 1
            kk = k[s, :n].double().repeat_interleave(2, 1)
            vv = v[s, :n].double().repeat_interleave(2, 1)
            w = torch.softmax(torch.einsum("hd,khd->hk", q[s, r].double(), kk)
                              / 4.0, -1)
            want = torch.einsum("hk,khd->hd", w, vv)
            torch.testing.assert_close(got[s, r].double(), want, atol=1e-5,
                                       rtol=0)


# ----------------------------------------------------------------------
# verify_step against the JAX package's
# ----------------------------------------------------------------------

B, L0, T = 3, 8, 4
POS = np.array([L0, L0 + 2, -1], np.int32)
N_TOK = np.array([4, 2, 0], np.int32)


def _prefilled(m):
    """Both packages' dense caches after a batch-3 prefill of L0 tokens
    (+ 2 more for slot 1, through two decode steps)."""
    jcfg, cfg = m["jcfg"], m["cfg"]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (B, L0 + 2)).astype(np.int32)
    cache = M.init_cache(cfg, B, 32, "cpu")
    M.prefill(cfg, m["params"], {"tokens": torch.from_numpy(toks[:, :L0])
                                 .long()}, cache)
    for i in range(2):
        M.decode_step(cfg, m["params"], torch.from_numpy(toks[:, L0 + i:
                                                              L0 + i + 1]).long(),
                      torch.tensor([-1, L0 + i, -1], dtype=torch.int32), cache)
    return cache, rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)


def _to_pages(cache, ps, quant):
    """A dense cache's rows laid into a page pool, slot b's logical page j
    at pool page j * B + b (interleaved); -1 past the 32 rows."""
    n_layers, b, tmax, hkv, d = cache["k"].shape
    pp = tmax // ps
    table = (torch.arange(pp)[None] * b + torch.arange(b)[:, None]).int()
    pages = {}
    for name in ("k", "v"):
        x = cache[name].reshape(n_layers, b, pp, ps, hkv, d).transpose(1, 2) \
            .reshape(n_layers, pp * b, ps, hkv, d).contiguous()
        if quant:
            qx, s = precision.quantize_kv(x)
            pages[name], pages[name + "s"] = qx, s.transpose(2, 3).contiguous()
        else:
            pages[name] = x
    return {"pages": pages, "table": table}


@pytest.mark.parametrize("layout", ["dense", "paged", "paged-int8"])
def test_verify_step_matches_jax(model, layout):
    """Logits of every real row (slot 0's 4, slot 1's 2) within atol 1e-4
    of the JAX package's, the cache within it too (int8 pages within one
    step of the quantization and the scales within atol), and no row
    past a slot's real tokens written."""
    m = model
    jcfg, cfg = m["jcfg"], m["cfg"]
    dense, tokens = _prefilled(m)
    cache = dense if layout == "dense" else _to_pages(
        dense, 8, layout == "paged-int8")
    before = {k: v.clone() for k, v in
              (cache["pages"] if "pages" in cache else cache).items()}
    jcache = jax.tree.map(lambda x: jnp.asarray(x.numpy()), cache)
    logits, _ = M.verify_step(cfg, m["params"], torch.from_numpy(tokens).long(),
                              torch.from_numpy(POS), torch.from_numpy(N_TOK),
                              cache)
    with PALLAS.scope():
        jlog, jcache = JM.verify_step(jcfg, m["jparams"], jnp.asarray(tokens),
                                      jnp.asarray(POS), jnp.asarray(N_TOK),
                                      jcache)
    assert logits.shape == (B, T, cfg.padded_vocab)
    for s in range(B):
        n = int(N_TOK[s])
        np.testing.assert_allclose(logits[s, :n].numpy(),
                                   np.asarray(jlog)[s, :n], atol=ATOL, rtol=0)
    got = cache["pages"] if "pages" in cache else cache
    want = jcache["pages"] if "pages" in jcache else jcache
    for name in got:
        g, w = got[name].numpy(), np.asarray(want[name])
        if g.dtype == np.int8:
            assert np.abs(g.astype(int) - w.astype(int)).max() <= 1, name
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    # rows past each slot's real tokens are left as they were
    table = cache.get("table")
    for s in range(B):
        for p in range(32):
            if POS[s] >= 0 and POS[s] <= p < POS[s] + N_TOK[s]:
                continue
            for name in ("k", "v"):
                if table is None:
                    old, new = before[name][:, s, p], got[name][:, s, p]
                else:
                    phys, off = int(table[s, p // 8]), p % 8
                    old, new = before[name][:, phys, off], got[name][:, phys, off]
                assert torch.equal(old, new), (s, p, name)


def test_verify_rows_are_decode_rows_bit_for_bit(model):
    """A verify step over (pending, d1, d2, d3) writes the cache rows and
    gives the logits rows of four decode steps fed the same tokens, bit
    for bit, on the CPU at two slots."""
    m = model
    cfg = m["cfg"]
    dense, tokens = _prefilled(m)
    pos = torch.tensor([L0, L0 + 2], dtype=torch.int32)
    a = {k: v[:, :2].clone() for k, v in dense.items()}
    b = {k: v[:, :2].clone() for k, v in dense.items()}
    toks = torch.from_numpy(tokens[:2]).long()
    vlog, _ = M.verify_step(cfg, m["params"], toks, pos,
                            torch.tensor([4, 4], dtype=torch.int32), a)
    for r in range(T):
        dlog, _ = M.decode_step(cfg, m["params"], toks[:, r:r + 1], pos + r, b)
        torch.testing.assert_close(vlog[:, r], dlog[:, 0], atol=1e-5, rtol=0)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_verify_step_refuses_ssm():
    cfg = get_config("mamba2-2.7b", reduced=True)
    with pytest.raises(ValueError, match="attention cache"):
        M.verify_step(cfg, {}, torch.zeros((1, 2), dtype=torch.long),
                      torch.zeros(1, dtype=torch.int32),
                      torch.ones(1, dtype=torch.int32), {})


# ----------------------------------------------------------------------
# the spec engine
# ----------------------------------------------------------------------

KW = dict(max_slots=2, max_len=64, page_size=8)
LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged"),
           "paged-int8": dict(kv_layout="paged", quant_kv="int8")}


def _serve(eng, prompts, snap=None):
    reqs = [eng.submit(p, g) for p, g in zip(prompts, GENS)]
    if snap is not None:
        release = eng._release

        def keep(req, slot, now, *a):
            n = req.prompt_len + req.n_generated - 1   # rows of fed tokens
            snap[req.rid] = _slot_rows(eng, slot, n)
            release(req, slot, now, *a)
        eng._release = keep
    return reqs, eng.run()


def _slot_rows(eng, slot, n):
    """A slot's first n K/V rows of every layer, gathered from its pages
    in paged mode."""
    if eng.pool is None:
        return {k: v[:, slot, :n].clone() for k, v in eng.cache.items()}
    ps = eng.page_size
    pages = eng.cache["pages"]
    out = {}
    for name in ("k", "v"):
        rows = [pages[name][:, int(eng.pool.table[slot, p // ps]), p % ps]
                for p in range(n)]
        out[name] = torch.stack(rows, 1)
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("which", ["self", "seed1"])
def test_spec_streams_equal_nonspec_and_jax_spec(model, layout, which):
    """Greedy spec streams equal the port's non-spec streams and the JAX
    spec engine's, token for token, with the JAX engine's acceptance
    counts; a self-draft accepts every proposal."""
    m = model
    cfg, jcfg = m["cfg"], m["jcfg"]
    draft = (cfg, m["params"] if which == "self" else m["draft"])
    jdraft = (jcfg, m["jparams"] if which == "self" else m["jdraft"])
    lay = LAYOUTS[layout]
    base, _ = _serve(ServingEngine(cfg, m["params"], device="cpu", **KW,
                                   **lay), m["prompts"])
    reqs, rep = _serve(ServingEngine(cfg, m["params"], device="cpu", **KW,
                                     draft=draft, spec_k=4, **lay),
                       m["prompts"])
    pol = PALLAS.replace(kv_layout=lay.get("kv_layout", "dense"),
                         quant_kv=lay.get("quant_kv", "off"))
    jreqs, jrep = _serve(JaxEngine(jcfg, m["jparams"], policy=pol, draft=jdraft,
                                   spec_k=4, **KW), m["prompts"])
    assert [r.generated for r in reqs] == [r.generated for r in base]
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    for key in ("spec_rounds", "spec_proposed", "spec_accepted",
                "n_finished", "decode_tokens"):
        assert rep[key] == jrep[key], key
    assert [(r.draft_proposed, r.draft_accepted) for r in reqs] == \
        [(r.draft_proposed, r.draft_accepted) for r in jreqs]
    if which == "self" and layout != "paged-int8":
        assert rep["spec_acceptance_rate"] == 1.0
        assert rep["tokens_per_step"] > 1.5
    if which == "seed1":
        assert rep["spec_acceptance_rate"] < 0.5


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spec_target_cache_rows_equal_nonspec_bit_for_bit(model, layout):
    """After a run full of rejections (the draft of other weights), each
    request's target cache rows up to its last fed token equal the
    non-spec run's bit for bit: every verify row is a decode row."""
    m = model
    cfg = m["cfg"]
    lay = LAYOUTS[layout]
    want, got = {}, {}
    base, _ = _serve(ServingEngine(cfg, m["params"], device="cpu", **KW,
                                   **lay), m["prompts"], want)
    reqs, rep = _serve(ServingEngine(cfg, m["params"], device="cpu", **KW,
                                     draft=(cfg, m["draft"]), spec_k=3,
                                     **lay), m["prompts"], got)
    assert [r.generated for r in reqs] == [r.generated for r in base]
    assert rep["spec_acceptance_rate"] < 0.5
    assert sorted(got) == sorted(want) == list(range(len(LENGTHS)))
    for rid in want:
        for name in ("k", "v"):
            assert torch.equal(got[rid][name], want[rid][name]), (rid, name)


def test_spec_eos_truncates_mid_round(model):
    """With a self-draft a round emits up to 5 tokens; an eos inside one
    ends the request right after it, as the non-spec engine does."""
    m = model
    cfg = m["cfg"]
    base, _ = _serve(ServingEngine(cfg, m["params"], device="cpu", **KW),
                     m["prompts"])
    eos = base[2].generated[3]
    plain, _ = _serve(ServingEngine(cfg, m["params"], device="cpu", **KW,
                                    eos_id=eos), m["prompts"])
    reqs, rep = _serve(ServingEngine(cfg, m["params"], device="cpu", **KW,
                                     eos_id=eos, draft=(cfg, m["params"])),
                       m["prompts"])
    assert [r.generated for r in reqs] == [r.generated for r in plain]
    assert reqs[2].generated[-1] == eos
    assert len(reqs[2].generated) < GENS[2]


def test_verify_step_runs_on_the_engines_static_tensors(model, monkeypatch):
    """What a captured verify graph needs: every round calls verify_step
    on the same token, position, count and cache tensors."""
    m = model
    cfg = m["cfg"]
    eng = ServingEngine(cfg, m["params"], device="cpu", kv_layout="paged",
                        draft=(cfg, m["draft"]), spec_k=3, **KW)
    seen = set()
    verify = M.verify_step

    def recording(cfg_, params_, tokens, pos, n_tok, cache):
        seen.add((tokens.data_ptr(), pos.data_ptr(), n_tok.data_ptr(),
                  cache["table"].data_ptr(),
                  *(t.data_ptr() for t in cache["pages"].values())))
        return verify(cfg_, params_, tokens, pos, n_tok, cache)
    monkeypatch.setattr(M, "verify_step", recording)
    _serve(eng, m["prompts"])
    assert len(seen) == 1 and eng.spec_rounds > 1


def test_draft_rollback_is_positional_bit_for_bit(model):
    """Two drafts whose caches differ only in stale rows past the pending
    position (a 4-proposal round against a 1-proposal one) draft the
    next round alike and write the same rows, bit for bit."""
    m = model
    cfg = m["cfg"]
    ctx = np.random.default_rng(1).integers(0, cfg.vocab, (12,)) \
        .astype(np.int32)
    k = 4

    def decoder():
        d = SpecDecoder(cfg, m["params"], max_slots=2, max_len=48, spec_k=k,
                        device="cpu")
        d.admit(0, ctx)
        return d

    pos = np.array([12, -1], np.int32)
    tok = np.array([[5], [0]])
    da, db = decoder(), decoder()
    ra, _ = da.draft_round(tok, pos, np.array([k, 0]))
    rb, _ = db.draft_round(tok, pos, np.array([1, 0]))
    assert ra[0, 0] == rb[0, 0]
    c = np.array([[int(ra[0, 0]) ^ 1], [0]])
    pos1 = np.array([13, -1], np.int32)
    r2a, _ = da.draft_round(c, pos1, np.array([k, 0]))
    r2b, _ = db.draft_round(c, pos1, np.array([k, 0]))
    np.testing.assert_array_equal(r2a, r2b)
    for name in ("k", "v"):
        assert torch.equal(da.cache[name][:, 0, :14 + k],
                           db.cache[name][:, 0, :14 + k]), name


def test_spec_validation_errors(model):
    m = model
    cfg = m["cfg"]
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(cfg, m["params"], device="cpu", max_slots=1, max_len=32,
                      draft=(dataclasses.replace(cfg, vocab=128), m["params"]))
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(cfg, m["params"], device="cpu", max_slots=1, max_len=32,
                      draft=(cfg, m["params"]), spec_k=0)
    scfg = get_config("mamba2-2.7b", reduced=True)
    sparams = M.init_params(scfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="verify-capable"):
        ServingEngine(scfg, sparams, device="cpu", max_slots=1, max_len=32,
                      draft=(cfg, m["params"]))
    with pytest.raises(ValueError, match="dense"):
        SpecDecoder(scfg, sparams, max_slots=1, max_len=32, device="cpu")
