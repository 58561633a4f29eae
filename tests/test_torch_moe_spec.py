"""Greedy speculative decoding with a moe target: mixtral-8x22b at its
reduced size (4 experts top-2, groups of 32, window 32), f32, on the JAX
package's weights bridged leaf for leaf, 2 slots, spec_k 4.

A verify step routes its 2 x 5 rows as one group. At the reduced
config's capacity factor of 1.25 an expert takes max(4, int(2 x 10 x
1.25 / 4)) = 6 of them, so capacity binds; at a capacity factor of 2.0
it takes 10, every row of the group, and no round can drop an
assignment. What the streams are held to:
  * where no round drops (capacity 10): the port's plain engine's
    streams and the JAX spec engine's, token for token, with the JAX
    engine's acceptance counts, on the dense cache and a page pool, for
    a draft of other weights and the target as its own draft;
  * where rounds drop (capacity 6): each round's verify logits are
    `M.verify_step`'s on the engine's (2, 5) block, its zero rows
    included (idle slots, rows past n_tok), and the emitted tokens
    follow the greedy rule on those logits; a request whose real rows
    dropped nothing keeps the plain engine's stream.

Rows that attend no key (an idle slot's, a row past its slot's n_tok)
hold token 0 and carry its embedding alone, so they route alike and
take capacity from real rows: a difference by design, which
`test_zero_rows_route_alike_and_take_capacity` shows.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.policy import Policy
from repro.models import model as JM
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import moe as PMoE
from repro_torch.serving import ServingEngine

PALLAS = Policy(backend="pallas", interpret=True)
ARCH = "mixtral-8x22b"
LENGTHS = [36, 12, 34, 9]           # two past the window of 32
GENS = [6, 5, 7, 6]
KW = dict(max_slots=2, max_len=64, page_size=8)
K = 4
LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged")}


def _cfgs(capacity_factor=None):
    jcfg = dataclasses.replace(jax_get_config(ARCH, reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), dtype="float32")
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return jcfg, cfg


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jdraft = JM.init_params(jcfg, jax.random.PRNGKey(1))
    conv = lambda p: params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, jcfg.vocab, (n,)).astype(np.int32)
               for n in LENGTHS]
    return dict(jparams=jparams, params=conv(jparams), jdraft=jdraft,
                draft=conv(jdraft), prompts=prompts)


def _serve(eng, prompts):
    reqs = [eng.submit(p, g) for p, g in zip(prompts, GENS)]
    rep = eng.run()
    assert rep["n_finished"] == len(reqs)
    return reqs, rep


@pytest.mark.parametrize("layout,which", [("dense", "seed1"),
                                          ("paged", "self")])
def test_no_drop_streams_equal_plain_and_jax_spec(weights, layout, which):
    """At a capacity of 10 for a round's 10 rows no round drops (the
    engine's records say so): the spec streams equal the port's plain
    engine's and the JAX spec engine's, token for token, with the JAX
    engine's acceptance counts, in all and by request; a draft of other
    weights on the dense cache, the target as its own draft on a page
    pool (every proposal accepted)."""
    w = weights
    jcfg, cfg = _cfgs(capacity_factor=2.0)
    assert PMoE._capacity(cfg.moe, 2 * (K + 1)) == 2 * (K + 1)
    lay = LAYOUTS[layout]
    draft = w["params"] if which == "self" else w["draft"]
    jdraft = w["jparams"] if which == "self" else w["jdraft"]
    base, _ = _serve(ServingEngine(cfg, w["params"], device="cpu", **KW,
                                   **lay), w["prompts"])
    eng = ServingEngine(cfg, w["params"], device="cpu", **KW, **lay,
                        draft=(cfg, draft), spec_k=K)
    reqs, rep = _serve(eng, w["prompts"])
    pol = PALLAS.replace(kv_layout=lay.get("kv_layout", "dense"))
    jreqs, jrep = _serve(JaxEngine(jcfg, w["jparams"], policy=pol,
                                   draft=(jcfg, jdraft), spec_k=K, **KW),
                         w["prompts"])
    assert rep["spec_rounds"] > 1 and eng.verify_rows > rep["spec_rounds"]
    assert rep["verify_dropped"] == 0 and rep["verify_rounds_dropping"] == 0
    assert [r.generated for r in reqs] == [r.generated for r in base]
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    for key in ("spec_rounds", "spec_proposed", "spec_accepted",
                "n_finished", "decode_tokens"):
        assert rep[key] == jrep[key], key
    assert [(r.draft_proposed, r.draft_accepted) for r in reqs] == \
        [(r.draft_proposed, r.draft_accepted) for r in jreqs]
    if which == "self":
        assert rep["spec_acceptance_rate"] == 1.0
    else:
        assert rep["spec_acceptance_rate"] < 1.0


def _greedy(rows, drafts, n):
    """The greedy acceptance rule on a slot's n verify rows: the drafts
    while each equals its row's argmax, then the first row's argmax
    that differs, or the bonus row's."""
    out = []
    for j in range(n - 1):
        out.append(int(np.argmax(rows[j])))
        if out[-1] != drafts[j]:
            return out
    out.append(int(np.argmax(rows[n - 1])))
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_dropping_rounds_follow_verify_logits_and_greedy_rule(weights,
                                                              layout):
    """At the reduced config's capacity of 6 for 10 rows, rounds drop
    assignments, real rows' among them. Each round's verify logits and
    drops equal `M.verify_step` on a clone of the engine's block and
    cache (its zero rows included), bit for bit; each request's stream is
    its first token and then, round by round, the greedy rule's tokens
    on those logits, cut at its budget; a request whose real rows
    dropped nothing keeps the plain engine's stream."""
    w = weights
    _, cfg = _cfgs()
    lay = LAYOUTS[layout]
    base, _ = _serve(ServingEngine(cfg, w["params"], device="cpu", **KW,
                                   **lay), w["prompts"])
    eng = ServingEngine(cfg, w["params"], device="cpu", **KW, **lay,
                        draft=(cfg, w["params"]), spec_k=K)
    rounds = []
    verify = eng._verify_step

    def checked():
        args = (eng._v_tokens.clone(), eng._step_pos.clone(),
                eng._v_ntok.clone())
        cache = {k: v.clone() for k, v in eng.cache.items()} \
            if "pages" not in eng.cache else dict(
                eng.cache, pages={k: v.clone() for k, v in
                                  eng.cache["pages"].items()},
                table=eng.cache["table"].clone())
        logits = verify()
        drops = eng._v_drops.clone()
        want_drops = []
        want, _ = M.verify_step(cfg, eng.params, *args, cache,
                                drops=want_drops)
        assert torch.equal(logits, want)
        assert torch.equal(drops, torch.stack(want_drops).sum(0))
        rounds.append(dict(
            rows=logits[:, :, :cfg.vocab].numpy().copy(),
            drafts=args[0][:, 1:].numpy().copy(),
            n_tok=args[2].numpy().copy(), drops=drops.numpy().copy(),
            rids={s: r.rid for s, r in eng.scheduler.active.items()}))
        return logits
    eng._verify_step = checked
    reqs, rep = _serve(eng, w["prompts"])

    real = [int(r["drops"][s, :r["n_tok"][s]].sum()) for r in rounds
            for s in range(2)]
    assert sum(real) > 0, "no real row dropped: the trace tests nothing"
    assert rep["verify_dropped"] == sum(real) == \
        sum(r.verify_dropped for r in reqs)
    assert rep["verify_rounds_dropping"] == sum(bool(r["drops"].any())
                                                for r in rounds)
    streams = {r.rid: [r.generated[0]] for r in reqs}
    for r in rounds:
        for s, rid in r["rids"].items():
            n = int(r["n_tok"][s])
            streams[rid] += _greedy(r["rows"][s], r["drafts"][s], n)
    for req in reqs:
        assert req.generated == streams[req.rid][:req.max_new_tokens], \
            req.rid
    kept = [i for i, r in enumerate(reqs) if r.verify_dropped == 0]
    for i in kept:
        assert reqs[i].generated == base[i].generated, i


def test_zero_rows_route_alike_and_take_capacity(weights, monkeypatch):
    """A verify block with slot 0 busy (3 real rows) and slot 1 idle: its
    7 zero rows hold token 0 and attend no key, so each carries token 0's
    embedding alone. At the first layer they route to the same two
    experts (their router logits equal each other's, not tied among the
    experts), and their first choices take slots that a real row's
    second choice then misses: a real row loses an assignment that it
    keeps when the block is its 3 rows alone (3 rows, capacity 4: none
    can drop)."""
    w = weights
    _, cfg = _cfgs()
    routes = []
    route = PMoE._route

    def recording(p, xg, mc):
        out = route(p, xg, mc)
        routes.append((out[0][0].clone(), out[3][0].clone(),
                       out[5][0].clone()))
        return out
    monkeypatch.setattr(PMoE, "_route", recording)
    ctx = w["prompts"][0][:20]
    results = {}
    for name, slots, t in (("block", 2, K + 1), ("alone", 1, 3)):
        _, cache = M.prefill(
            cfg, w["params"], {"tokens": torch.from_numpy(
                np.stack([ctx] * slots)).long()},
            M.init_cache(cfg, slots, 64, "cpu"))
        tokens = torch.zeros((slots, t), dtype=torch.long)
        tokens[0, :3] = torch.tensor([11, 200, 3])
        pos = torch.tensor([20, -1][:slots], dtype=torch.int32)
        n_tok = torch.tensor([3, 0][:slots], dtype=torch.int32)
        routes.clear()
        M.verify_step(cfg, w["params"], tokens, pos, n_tok, cache)
        results[name] = routes[0]
    logits, top_i, keep = results["block"]
    zero = list(range(3, 2 * (K + 1)))
    for r in zero[1:]:
        assert torch.equal(logits[r], logits[zero[0]])
        assert torch.equal(top_i[r], top_i[zero[0]])
    assert len(set(logits[zero[0]].tolist())) == cfg.moe.n_experts
    _, _, keep_alone = results["alone"]
    assert keep_alone[:3].all()
    assert not keep[:3].all(), "no real row lost an assignment"
