"""The port's request surface against the JAX package's: the sampler, the
trace registry, and the engine's deadlines, priority preemption, eos and
prefill bucketing, served side by side with the JAX engine; cancel held
to each request served alone.

Both engines run the reduced qwen3 config in float32 on the JAX
package's weights (bridged into the port), the JAX one under
`Policy(backend="pallas", interpret=True)`. They read one step-driven
clock: each instance's `_now` is replaced by a counter that `_drive`
advances by one after every `step()`, so arrivals, deadlines and
preemption backoffs (in steps) fall at the same step in both.
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
from repro.serving import sampler as jsampler
from repro.serving import workload as jworkload
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.serving import (TRACES, ServingEngine, SlotScheduler,
                                 make_trace, residual_distribution)
from repro_torch.serving import sampler as tsampler
from repro_torch.serving.request import (ACTIVE, CANCELLED, EXPIRED,
                                         FINISHED, WAITING, Request)

PALLAS = Policy(backend="pallas", interpret=True)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
            for n in lengths]


def _clock(*engines):
    """One step-driven clock for `engines`; returns its tick function."""
    now = {"t": 0.0}
    for eng in engines:
        eng._now = lambda: now["t"]

    def tick():
        now["t"] += 1.0
    return tick


def _drive(eng, tick, max_steps=500):
    for _ in range(max_steps):
        more = eng.step()
        tick()
        if not more:
            return eng.report()
    raise AssertionError("the engine did not drain its work")


def _port(cfg, params, **kw):
    return ServingEngine(cfg, params, device="cpu", **kw)


def _jax(jcfg, jparams, kv_layout="dense", **kw):
    return JaxEngine(jcfg, jparams, policy=PALLAS.replace(kv_layout=kv_layout),
                     **kw)


def _outcome(reqs, report, keys=("n_finished", "expired", "cancelled",
                                 "preempted", "quarantined", "useful_tokens",
                                 "decode_steps")):
    return ([(r.rid, r.status, r.generated, r.preemptions, r.t_admitted,
              r.t_first_token, r.t_finished) for r in reqs],
            {k: report[k] for k in keys})


def _alone(cfg, params, prompt, n_new, **kw):
    """`prompt`'s stream served alone in a fresh one-slot port engine."""
    eng = _port(cfg, params, max_slots=1, max_len=64, **kw)
    req = eng.submit(prompt, n_new)
    eng.run()
    assert req.status == FINISHED
    return req.generated


# ----------------------------------------------------------------------
# the sampler: the JAX package's draws on the same rows and seed
# ----------------------------------------------------------------------

SAMPLERS = [dict(kind="greedy"), dict(kind="temperature", temperature=0.7),
            dict(kind="temperature", temperature=1.3, top_k=5)]


@pytest.mark.parametrize("kw", SAMPLERS, ids=lambda k: "-".join(
    str(v) for v in k.values()))
def test_sampler_draws_equal_the_jax_samplers(kw):
    rows = np.random.default_rng(0).standard_normal((30, 64)) \
        .astype(np.float32) * 3
    mine = tsampler.make_sampler(seed=11, **{k: v for k, v in kw.items()
                                             if k != "kind"},
                                 kind=kw["kind"])
    ref = jsampler.make_sampler(seed=11, **{k: v for k, v in kw.items()
                                            if k != "kind"},
                                kind=kw["kind"])
    assert [mine(r) for r in rows] == [ref(r) for r in rows]
    for r in rows[:5]:
        np.testing.assert_array_equal(mine.probs(r), ref.probs(r))
    assert mine.config == tsampler.SamplerConfig(**kw)


@pytest.mark.parametrize("kw", SAMPLERS, ids=lambda k: "-".join(
    str(v) for v in k.values()))
@pytest.mark.parametrize("with_q", [False, True])
def test_speculative_accept_equals_the_jax_rule(kw, with_q):
    """The same target rows, proposals and draft distributions give the
    same emitted tokens and acceptance counts, round after round on one
    rng stream; and the residual distribution is the JAX package's."""
    rng = np.random.default_rng(5)
    mine = tsampler.make_sampler(seed=3, **{k: v for k, v in kw.items()
                                            if k != "kind"}, kind=kw["kind"])
    ref = jsampler.make_sampler(seed=3, **{k: v for k, v in kw.items()
                                           if k != "kind"}, kind=kw["kind"])
    k, vocab = 4, 32
    for _ in range(12):
        target = rng.standard_normal((k + 1, vocab)).astype(np.float32) * 2
        drafts = rng.integers(0, vocab, k)
        q = None
        if with_q:
            q = rng.random((k, vocab))
            q /= q.sum(-1, keepdims=True)
        assert mine.speculative_accept(target, drafts, q) == \
            ref.speculative_accept(target, drafts, q)
    p, q = rng.random(vocab), rng.random(vocab)
    np.testing.assert_array_equal(residual_distribution(p, q),
                                  jsampler.residual_distribution(p, q))


def test_greedy_of_the_sampler_is_the_argmax():
    rows = np.random.default_rng(1).standard_normal((10, 40)).astype(np.float32)
    s = tsampler.Sampler()
    assert [s(r) for r in rows] == [tsampler.greedy(r) for r in rows]


# ----------------------------------------------------------------------
# the trace registry: the JAX package's requests from one seed
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jworkload.TRACES))
def test_make_trace_equals_the_jax_trace(name):
    assert set(TRACES) == set(jworkload.TRACES)
    cfg = get_config("qwen3-0.6b", reduced=True)
    jcfg = jax_get_config("qwen3-0.6b", reduced=True)
    kw = dict(gen=5, arrival_rate=3.0, deadline=0.75,
              priority_levels=(0, 1, 2))
    if name != "bursty":
        kw["burst_size"] = 2
    mine = make_trace(name, cfg, 11, rng=np.random.default_rng(7), **kw)
    ref = jworkload.make_trace(name, jcfg, 11, rng=np.random.default_rng(7),
                               **kw)
    assert len(mine) == len(ref) == 11
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.gen, a.arrival, a.deadline, a.priority) == \
            (b.gen, b.arrival, b.deadline, b.priority)


def test_unknown_workload_raises():
    with pytest.raises(ValueError, match="unknown workload"):
        make_trace("nope", get_config("qwen3-0.6b", reduced=True), 2,
                   rng=np.random.default_rng(0))


# ----------------------------------------------------------------------
# the request and the scheduler
# ----------------------------------------------------------------------

def test_request_fields_and_deadline_validation():
    req = Request(rid=0, prompt=np.arange(3), max_new_tokens=5,
                  deadline=2.0)
    req.generated += [7, 8]
    np.testing.assert_array_equal(req.context_tokens(), [0, 1, 2, 7, 8])
    assert req.remaining_tokens == 3 and req.missed_deadline is None
    assert req.acceptance_rate is None
    req.status, req.t_finished = FINISHED, 2.5
    assert req.missed_deadline is True
    with pytest.raises(ValueError, match="deadline"):
        Request(rid=1, prompt=np.arange(3), max_new_tokens=1,
                arrival_time=1.0, deadline=0.5)


def test_scheduler_preempt_keeps_rid_order_and_backoff():
    sch = SlotScheduler(2)
    reqs = [Request(rid=i, prompt=np.arange(2), max_new_tokens=2)
            for i in range(4)]
    for r in reqs:
        sch.submit(r)
    assert sch.admit(sch.next_admission(0.0)) == 0      # rid 0
    assert sch.admit(sch.next_admission(0.0)) == 1      # rid 1
    sch.preempt(1, resume_at=5.0)
    assert reqs[1].status == WAITING and reqs[1].slot == -1
    assert [r.rid for r in sch._waiting] == [1, 2, 3]
    assert sch.next_admission(1.0) is reqs[2]   # rid 1 backs off until 5
    assert sch.next_admission(5.0) is reqs[1]
    reqs[3].deadline = 0.5
    assert sch.drop_expired(1.0) == [reqs[3]] and reqs[3].status == EXPIRED
    sch.remove_waiting(reqs[2])
    with pytest.raises(ValueError, match="not waiting"):
        sch.remove_waiting(reqs[2])
    assert sch.next_arrival_time() == 5.0


# ----------------------------------------------------------------------
# the engine beside the JAX engine, on one step clock
# ----------------------------------------------------------------------

def test_deadline_expires_a_waiter_as_the_jax_engine(model):
    """One slot: a waiter whose deadline (half a step) passes behind the
    active request is dropped unadmitted (EXPIRED, counted, a miss) in
    both engines, and everything else agrees."""
    jcfg, jparams, cfg, params = model
    prompts = _prompts(cfg, [10, 10, 9], seed=53)

    def run(eng):
        tick = _clock(eng)
        reqs = [eng.submit(prompts[0], 6),
                eng.submit(prompts[1], 4, deadline=0.5),
                eng.submit(prompts[2], 3, deadline=60.0)]
        return reqs, _drive(eng, tick)

    want = run(_jax(jcfg, jparams, max_slots=1, max_len=32))
    reqs, rep = run(_port(cfg, params, max_slots=1, max_len=32))
    assert _outcome(reqs, rep) == _outcome(*want)
    assert [r.status for r in reqs] == [FINISHED, EXPIRED, FINISHED]
    assert reqs[1].t_admitted is None and reqs[1].missed_deadline is True
    assert rep["expired"] == 1 and rep["deadline_miss_rate"] == 0.5
    assert rep["goodput"] == 1.0


PREEMPT = dict(max_slots=2, max_len=32, page_size=8, kv_pool_pages=5,
               preempt_backoff=1.5)


@pytest.mark.parametrize("vip_priority", [1, 0])
def test_preemption_as_the_jax_engine(model, vip_priority):
    """A 5-page pool: the victim (priority 0, 12 + 8 tokens) holds 4
    pages when the head (10 + 4 tokens) arrives. A higher-priority head
    preempts it (its pages back to the pool), and the victim resumes
    into its uninterrupted stream once the head is done; an equal-
    priority head waits instead. Both as the JAX engine does it, step
    for step."""
    jcfg, jparams, cfg, params = model
    prompts = _prompts(cfg, [12, 10], seed=31)

    def run(eng):
        tick = _clock(eng)
        victim = eng.submit(prompts[0], 8, priority=0)
        for _ in range(3):
            eng.step()
            tick()
        assert victim.status == ACTIVE and len(victim.generated) == 4
        head = eng.submit(prompts[1], 4, arrival_time=3.0,
                          priority=vip_priority)
        return [victim, head], _drive(eng, tick)

    want = run(_jax(jcfg, jparams, "paged", **PREEMPT))
    eng = _port(cfg, params, kv_layout="paged", **PREEMPT)
    reqs, rep = run(eng)
    assert _outcome(reqs, rep) == _outcome(*want)
    victim, head = reqs
    assert rep["preempted"] == victim.preemptions == vip_priority
    assert victim.status == head.status == FINISHED
    assert victim.generated == _alone(cfg, params, prompts[0], 8)
    assert head.generated == _alone(cfg, params, prompts[1], 4)
    assert (eng.pool.refcount == 0).all() and eng.pool.n_reserved == 0


def test_eos_and_prefill_chunk_as_the_jax_engine(model):
    """prefill_chunk 4 (buckets of 4, up to 3 remainder steps) and an eos
    token that one stream emits mid-way: the request stops at it (the
    eos kept), the others run to max_new, in both engines alike."""
    jcfg, jparams, cfg, params = model
    prompts = _prompts(cfg, [8, 13, 6, 19], seed=7)
    gens = [6, 5, 7, 4]
    free = _jax(jcfg, jparams, max_slots=2, max_len=32, prefill_chunk=4)
    tick = _clock(free)
    runs = [free.submit(p, g) for p, g in zip(prompts, gens)]
    _drive(free, tick)
    eos = runs[1].generated[2]

    def run(eng):
        tick = _clock(eng)
        reqs = [eng.submit(p, g) for p, g in zip(prompts, gens)]
        return reqs, _drive(eng, tick)

    want = run(_jax(jcfg, jparams, max_slots=2, max_len=32, prefill_chunk=4,
                    eos_id=eos))
    reqs, rep = run(_port(cfg, params, max_slots=2, max_len=32,
                          prefill_chunk=4, eos_id=eos))
    assert _outcome(reqs, rep) == _outcome(*want)
    cut = runs[1].generated.index(eos) + 1
    assert reqs[1].generated == runs[1].generated[:cut]
    for r, full in zip(reqs, runs):
        assert r.status == FINISHED
        if eos not in full.generated:
            assert r.generated == full.generated


def test_bursty_priorities_and_deadlines_as_the_jax_engine(model):
    """A bursty trace (groups of requests at once) with priority levels
    (0, 1) and deadlines, on a paged pool small enough to preempt: every
    status, stream, preemption and report count as the JAX engine's."""
    jcfg, jparams, cfg, params = model
    work = make_trace("bursty", cfg, 8, rng=np.random.default_rng(4),
                      len_range=(6, 20), gen=6, arrival_rate=0.5,
                      burst_mean=3.0, deadline=9.0, priority_levels=(0, 1))
    kw = dict(max_slots=3, max_len=32, page_size=8, kv_pool_pages=9,
              preempt_backoff=1.0)

    def run(eng):
        tick = _clock(eng)
        reqs = [eng.submit(it.prompt, it.gen, arrival_time=it.arrival,
                           deadline=it.deadline, priority=it.priority)
                for it in work]
        return reqs, _drive(eng, tick)

    want = run(_jax(jcfg, jparams, "paged", **kw))
    eng = _port(cfg, params, kv_layout="paged", **kw)
    reqs, rep = run(eng)
    assert _outcome(reqs, rep) == _outcome(*want)
    assert rep["n_finished"] > 0
    assert (eng.pool.refcount == 0).all() and eng.pool.n_reserved == 0


# ----------------------------------------------------------------------
# cancel, held to each request served alone
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_cancel_waiting_and_active_then_serve_alone(model, kv_layout):
    """A waiter and the active request are cancelled: both CANCELLED, the
    slot and every page free at once, False for a terminal request and
    ValueError for an unknown id; the next request's stream equals that
    request served alone. (The JAX engine's paged run of this scenario
    serves the next request a wrong stream.)"""
    _, _, cfg, params = model
    prompts = _prompts(cfg, [10, 12, 10], seed=61)
    eng = _port(cfg, params, max_slots=1, max_len=32, kv_layout=kv_layout,
                page_size=8)
    r0 = eng.submit(prompts[0], 6)
    r1 = eng.submit(prompts[1], 6)
    eng.step()                                  # r0 active, r1 waiting
    assert r0.status == ACTIVE and r1.status == WAITING
    assert eng.cancel(r1.rid) and r1.status == CANCELLED and r1.slot == -1
    assert eng.cancel(r0.rid) and r0.status == CANCELLED
    assert eng.scheduler.n_active == 0 and (eng._pos == -1).all()
    if eng.pool is not None:
        assert (eng.pool.refcount == 0).all() and eng.pool.n_reserved == 0
    assert not eng.cancel(r0.rid)
    with pytest.raises(ValueError, match="unknown request"):
        eng.cancel(999)
    r2 = eng.submit(prompts[2], 4)
    report = eng.run()
    assert r2.status == FINISHED
    assert r2.generated == _alone(cfg, params, prompts[2], 4,
                                  kv_layout=kv_layout, page_size=8)
    assert report["cancelled"] == 2 and report["n_finished"] == 1
    if eng.pool is not None:
        assert (eng.pool.refcount == 0).all()


def test_cancel_a_prefix_sharer_keeps_the_other_exact(model):
    """Two requests share a prompt's pages; cancelling one after the
    other's copy-on-write leaves the survivor's stream that of the
    prompt served alone, and every page free at the end."""
    _, _, cfg, params = model
    prompt = _prompts(cfg, [10], seed=67)[0]
    eng = _port(cfg, params, max_slots=2, max_len=32, kv_layout="paged",
                page_size=8)
    r0, r1 = eng.submit(prompt.copy(), 6), eng.submit(prompt.copy(), 6)
    eng.step()
    assert eng.pool.stats.cow_copies == 1
    assert eng.cancel(r0.rid)
    eng.run()
    assert r1.status == FINISHED
    assert r1.generated == _alone(cfg, params, prompt, 6, kv_layout="paged",
                                  page_size=8)
    assert (eng.pool.refcount == 0).all()
