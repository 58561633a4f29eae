"""The port's serving engine against the JAX package's, on the same
weights and trace: 4 prompts (lengths 8, 24, 13, 40; 13 runs the
prefill-remainder steps) over 2 slots, so requests 2 and 3 are admitted
mid-stream into freed slots. Greedy streams must be token-identical.
The engine's steps (the decode step and the admission's remainder step,
which the card captures in CUDA graphs) run here as plain calls: they
must take the scalar-position step's bits, read only the engine's
static tensors, and serve a second round of requests on the buffers of
the first as the JAX engine serves it.

Both engines run in float32; the JAX one under
`Policy(backend="pallas", interpret=True)`, the port's on the CPU.
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
from repro.serving import FaultInjector
from repro.serving import ServingEngine as JaxEngine
from repro.serving import make_sampler as jax_make_sampler
from repro.serving.workload import synthetic_trace as jax_synthetic_trace
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.tree import leaves
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.serving import ServingEngine, greedy, synthetic_trace
from repro_torch.serving.request import QUARANTINED

LENGTHS = [8, 24, 13, 40]
GENS = [5, 4, 7, 6]
# a second round, admitted once the first has drained: remainders 3, 5,
# none (shorter than a bucket) and 6
LENGTHS_2 = [11, 21, 6, 30]
ATOL = 1e-4


def _streams(engine, prompts):
    reqs = [engine.submit(p, g) for p, g in zip(prompts, GENS)]
    report = engine.run()
    assert report["n_finished"] == len(reqs)
    admitted = sorted(r.t_admitted for r in reqs)
    finished = sorted(r.t_finished for r in reqs)
    assert admitted[-1] > finished[0], "expected a mid-stream admission"
    return [r.generated for r in reqs]


def test_engine_streams_match_jax_engine():
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in LENGTHS]

    want = _streams(JaxEngine(jcfg, jparams, max_slots=2, max_len=64,
                              policy=Policy(backend="pallas", interpret=True)),
                    prompts)
    got = _streams(ServingEngine(cfg, params, max_slots=2, max_len=64,
                                 device="cpu"), prompts)
    assert got == want
    assert all(0 <= t < cfg.vocab for s in got for t in s)


def test_synthetic_trace_matches_jax_trace():
    cfg = get_config("qwen3-0.6b", reduced=True)
    kw = dict(len_range=(4, 20), gen=5, arrival_rate=3.0)
    mine = synthetic_trace(cfg, 6, rng=np.random.default_rng(3), **kw)
    ref = jax_synthetic_trace(jax_get_config("qwen3-0.6b", reduced=True), 6,
                              rng=np.random.default_rng(3), **kw)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.gen, a.arrival) == (b.gen, b.arrival)


def test_greedy_matches_jax_greedy_sampler():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((20, 64)).astype(np.float32)
    ref = jax_make_sampler("greedy")
    assert [greedy(r) for r in rows] == [ref(r) for r in rows]


@pytest.mark.parametrize("argv", [
    ["--reduced", "--device", "cpu", "--requests", "4", "--max-slots", "2"],
    ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "12",
     "--gen", "3"],
])
def test_serve_cli_smoke(argv, capsys):
    out = serve.main(argv)
    text = capsys.readouterr().out
    assert "arch=qwen3-0.6b-reduced" in text
    if "--requests" in argv:
        assert out["n_finished"] == 4
    else:
        assert out.shape == (2, 3)


def test_submit_beyond_max_len_raises():
    cfg = get_config("qwen3-0.6b", reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServingEngine(cfg, params, max_slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.zeros(12, np.int32), 8)


def _reduced_f32():
    """The reduced qwen3 config in float32 for both packages, the JAX
    package's weights (copied into the port) and the 4 prompts."""
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in LENGTHS]
    return jcfg, jparams, cfg, params, prompts


def _engine(cfg, params, kv_layout):
    return ServingEngine(cfg, params, max_slots=2, max_len=64, device="cpu",
                         kv_layout=kv_layout, page_size=8)


def _jax_engine(jcfg, jparams, kv_layout, **kw):
    return JaxEngine(jcfg, jparams, max_slots=2, max_len=64, page_size=8,
                     policy=Policy(backend="pallas", interpret=True,
                                   kv_layout=kv_layout), **kw)


def _run(eng, prompts):
    reqs = [eng.submit(p, g) for p, g in zip(prompts, GENS)]
    return reqs, eng.run()


def _outcome(reqs, report):
    """What the two engines must agree on: each request's status, error
    and stream, and the report's counts of quarantined and finished."""
    return ([(r.status, r.error, r.generated) for r in reqs],
            report["quarantined"], report["n_finished"])


def _assert_freed(eng):
    assert eng.scheduler.n_active == 0 and (eng._pos == -1).all()
    if eng.pool is not None:
        rep = eng.pool.report()
        assert rep["pages_free"] == rep["n_pages"], rep


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_nan_decode_row_quarantines_only_its_slot(kv_layout, monkeypatch):
    """Slot 1's logits row turns NaN at decode step 3: in the JAX engine
    through its FaultInjector, in the port through a wrapper of
    `decode_step`. Both engines must end the same request QUARANTINED
    with "non-finite logits at decode step 3", count it in their reports,
    and give every request the same status and stream; the port frees
    the slot and its pages."""
    jcfg, jparams, cfg, params, prompts = _reduced_f32()
    step, slot = 3, 1
    want = _outcome(*_run(_jax_engine(
        jcfg, jparams, kv_layout,
        fault_injector=FaultInjector(nan_rows={step: (slot,)})), prompts))

    eng = _engine(cfg, params, kv_layout)
    calls = {"n": 0}
    decode_step = M.decode_step

    def poisoned(cfg_, params_, tokens, pos, cache):
        logits, cache = decode_step(cfg_, params_, tokens, pos, cache)
        if tokens.shape[0] == eng.max_slots:      # an engine decode step
            if calls["n"] == step:
                logits = logits.clone()
                logits[slot] = float("nan")
            calls["n"] += 1
        return logits, cache
    monkeypatch.setattr(M, "decode_step", poisoned)
    got = _outcome(*_run(eng, prompts))

    assert got == want
    streams, quarantined, n_finished = got
    assert quarantined == 1 and n_finished == len(prompts) - 1
    assert [(s, e) for s, e, _ in streams if s == QUARANTINED] == \
        [(QUARANTINED, f"non-finite logits at decode step {step}")]
    _assert_freed(eng)


def test_nan_prefill_row_quarantines_only_its_request(monkeypatch):
    """The admission prefill of request 1 (24 tokens, no remainder steps)
    returns NaN logits in both engines (a wrapper of the JAX engine's
    jitted prefill, and of the port's `prefill`). Both must end request
    1 QUARANTINED with "non-finite logits at admission prefill" and no
    token, hand its slot to the next request, and agree on every status
    and stream; the port frees the slot and its pages."""
    jcfg, jparams, cfg, params, prompts = _reduced_f32()

    def poison_second(prefill):
        calls = {"n": 0}

        def poisoned(*args):
            logits, cache = prefill(*args)
            if calls["n"] == 1:
                logits = logits * float("nan")
            calls["n"] += 1
            return logits, cache
        return poisoned

    jeng = _jax_engine(jcfg, jparams, "dense")
    jeng._prefill = poison_second(jeng._prefill)
    want = _outcome(*_run(jeng, prompts))

    eng = _engine(cfg, params, "dense")
    monkeypatch.setattr(M, "prefill", poison_second(M.prefill))
    reqs, report = _run(eng, prompts)
    got = _outcome(reqs, report)

    assert got == want
    assert reqs[1].status == QUARANTINED and reqs[1].generated == []
    assert reqs[1].error == "non-finite logits at admission prefill"
    assert report["quarantined"] == 1
    assert report["n_finished"] == len(reqs) - 1
    _assert_freed(eng)


def test_remainder_step_equals_the_scalar_step_bit_for_bit():
    """The engine's remainder step (batch 1, its (1,) position vector:
    the per-slot cache write and decode attention, what the card
    captures) against the one-token step at a Python-int position (the
    slice write), on the same sub-cache, for 5 remainder tokens: logits
    and sub-cache bit for bit. Both equal the JAX package's decode_step
    at that position within atol 1e-4."""
    jcfg, jparams, cfg, params, prompts = _reduced_f32()
    prompt = prompts[2]                          # 13 tokens: 8 + 5
    eng = _engine(cfg, params, "dense")
    toks = torch.from_numpy(prompt).long()[None]
    M.prefill(cfg, eng.params, {"tokens": toks[:, :8]}, eng._sub)
    scalar = {k: v.clone() for k, v in eng._sub.items()}
    with Policy(backend="pallas", interpret=True).scope():
        _, jcache = JM.prefill(jcfg, jparams,
                               {"tokens": jnp.asarray(prompt[None, :8])},
                               JM.init_cache(jcfg, 1, eng.max_len))
        for i in range(8, len(prompt)):
            eng._rem_token.copy_(toks[:, i:i + 1])
            eng._rem_pos.fill_(i)
            got = eng._remainder_step()
            want, scalar = M.decode_step(cfg, eng.params, toks[:, i:i + 1], i,
                                         scalar)
            assert torch.equal(got, want), i
            for k in scalar:
                assert torch.equal(eng._sub[k], scalar[k]), (i, k)
            jlog, jcache = JM.decode_step(jcfg, jparams,
                                          jnp.asarray(prompt[None, i:i + 1]),
                                          jnp.int32(i), jcache)
            np.testing.assert_allclose(got.numpy(), np.asarray(jlog),
                                       atol=ATOL, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(eng._sub[k].numpy(), np.asarray(jcache[k]),
                                   atol=ATOL, rtol=0)


def test_engine_serves_two_rounds_as_the_jax_engine():
    """One engine serves the 4 requests, then 4 more (remainder tokens in
    both rounds) once the first have finished, on the sub-cache and step
    inputs the first round used: each round's streams equal those of one
    JAX engine serving the same two rounds, token for token."""
    jcfg, jparams, cfg, params, prompts = _reduced_f32()
    rng = np.random.default_rng(7)
    second = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
              for n in LENGTHS_2]

    def rounds(eng):
        out = []
        for batch in (prompts, second):
            reqs = [eng.submit(p, g) for p, g in zip(batch, GENS)]
            eng.run()
            assert all(len(r.generated) == r.max_new_tokens for r in reqs)
            out.append([r.generated for r in reqs])
        return out

    want = rounds(_jax_engine(jcfg, jparams, "dense"))
    got = rounds(_engine(cfg, params, "dense"))
    assert got == want


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_steps_run_on_the_engines_static_tensors(kv_layout, monkeypatch):
    """What a captured graph needs: every decode step and every remainder
    step calls decode_step on the same token, position and cache
    tensors (the paged table included), whose storage never moves, and
    at a position vector, never a Python int."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in LENGTHS]
    eng = _engine(cfg, params, kv_layout)
    seen = {}
    decode_step = M.decode_step

    def recording(cfg_, params_, tokens, pos, cache):
        assert isinstance(pos, torch.Tensor) and pos.dim() == 1
        seen.setdefault(tokens.shape[0], set()).add(
            tuple(t.data_ptr() for t in (tokens, pos, *leaves(cache))))
        return decode_step(cfg_, params_, tokens, pos, cache)
    monkeypatch.setattr(M, "decode_step", recording)
    _run(eng, prompts)
    assert sorted(seen) == [1, eng.max_slots]     # remainder and decode steps
    assert all(len(ptrs) == 1 for ptrs in seen.values()), seen
