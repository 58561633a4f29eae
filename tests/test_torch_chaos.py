"""The port's serving under scripted faults against the JAX engine's: the
chaos injector (`serving.faults.FaultInjector`) call for call, and the
engine under every schedule of the JAX package's `tests/test_chaos.py`
(a NaN logits row, a poisoned page on a bf16 and an int8 pool, a denied
admission that preempts or defers, kernel faults retried and then the
steps rebuilt, a crashed step, a slow step, all of them at once), on the
setup of `tests/test_torch_requests.py`: the reduced qwen3 in f32 on the
JAX package's weights, the JAX engine under
`Policy(backend="pallas", interpret=True)`, one step-driven clock.

Where the JAX engine falls back to plain XLA after repeated kernel
faults, the port rebuilds its captured steps on the same kernels; the
streams, statuses, errors and counters are the same. The rebuild's
state rule (no KV row written, the Mamba state put back) is held on a
reduced zamba2 engine whose rebuild runs the warm-ups a capture runs on
the card.
"""

import argparse
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.serving import FaultInjector as JaxInjector
from repro.serving import SimulatedKernelFault as JaxKernelFault
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.serving import (FaultInjector, ServingEngine,
                                 SimulatedKernelFault)
from repro_torch.serving import engine as E
from repro_torch.serving.request import ACTIVE, FINISHED, QUARANTINED
from test_torch_requests import (PALLAS, _alone, _clock, _drive, _port,
                                 _prompts, model)

# every report counter both engines keep (straggler_steps reads the wall
# clock, so it is held on the port alone)
COUNTERS = ("n_finished", "expired", "cancelled", "preempted", "quarantined",
            "kernel_faults", "crashed_steps", "degraded", "useful_tokens",
            "goodput", "decode_steps", "decode_tokens", "prefill_tokens",
            "tokens_per_step", "faults_injected")


def _jax(jcfg, jparams, kv_layout="dense", quant_kv="off", **kw):
    return JaxEngine(jcfg, jparams, policy=PALLAS.replace(
        kv_layout=kv_layout, quant_kv=quant_kv), **kw)


def _outcome(reqs, report):
    return ([(r.rid, r.status, r.error, r.generated, r.preemptions,
              r.t_admitted, r.t_finished) for r in reqs],
            {k: report[k] for k in COUNTERS})


def _side_by_side(model, script, run, kv_layout="dense", quant_kv="off",
                  **kw):
    """`run(engine, tick)` -> requests on the JAX engine and on the port,
    each with its own injector from `script` (FaultInjector kwargs), on
    one step clock each. Asserts the same outcome; returns the port's
    (engine, requests, report)."""
    jcfg, jparams, cfg, params = model
    jeng = _jax(jcfg, jparams, kv_layout, quant_kv,
                fault_injector=JaxInjector(**script), **kw)
    jreqs = run(jeng, _clock(jeng))
    eng = _port(cfg, params, kv_layout=kv_layout, quant_kv=quant_kv,
                fault_injector=FaultInjector(**script), **kw)
    reqs = run(eng, _clock(eng))
    assert _outcome(reqs, eng.report()) == _outcome(jreqs, jeng.report())
    return eng, reqs, eng.report()


def _submit_all(prompts, gens, **kw):
    def run(eng, tick):
        reqs = [eng.submit(p, g, **kw) for p, g in zip(prompts, gens)]
        _drive(eng, tick)
        return reqs
    return run


def _consistent(eng, report):
    """The report's terminal counts and goodput add up (the JAX test's
    `_check_consistency`)."""
    by = {s: sum(r.status == s for r in eng.requests)
          for s in (FINISHED, QUARANTINED, "expired", "cancelled")}
    assert report["n_finished"] == by[FINISHED]
    assert report["quarantined"] == by[QUARANTINED]
    assert sum(by.values()) == len(eng.requests)
    useful = sum(r.n_generated for r in eng.requests
                 if r.status == FINISHED and r.missed_deadline is not True)
    assert report["useful_tokens"] == useful
    assert report["goodput"] == useful / max(eng.tokens_emitted, 1)


# ----------------------------------------------------------------------
# the injector, call for call
# ----------------------------------------------------------------------

def test_fault_injector_scripting_and_fire_once_as_the_jax_one():
    script = dict(nan_rows={3: 1}, corrupt_pages={2: (0, 1)},
                  kernel_fail_steps=(5,), slow_steps={4: 0.0},
                  deny_admissions=(1,))
    mine, ref = FaultInjector(**script), JaxInjector(**script)
    for f in ("nan_rows", "corrupt_pages", "kernel_fail_steps",
              "slow_steps", "deny_admissions"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.nan_rows == {3: (1,)}
    rows = np.zeros((2, 4), np.float32)
    for step, slots in ((0, (0, 1)), (3, (0,)), (3, (0, 1)), (3, (0, 1))):
        got, want = mine.poison_rows(step, rows, slots), \
            ref.poison_rows(step, rows, slots)
        assert (got is rows) == (want is rows)
        np.testing.assert_array_equal(got, want)
    assert np.isfinite(rows).all()
    for step, slots in ((2, (0, 1, 2)), (2, (0, 1, 2)), (1, (0,))):
        assert mine.corrupt_slots(step, slots) == \
            ref.corrupt_slots(step, slots)
    with pytest.raises(SimulatedKernelFault, match="decode step 5"):
        mine.before_kernel(5)
    with pytest.raises(JaxKernelFault, match="decode step 5"):
        ref.before_kernel(5)
    for step in (5, 4, 4, 0):
        mine.before_kernel(step)
        ref.before_kernel(step)
    assert [mine.deny_admission(o) for o in (1, 1, 0, 2)] == \
        [ref.deny_admission(o) for o in (1, 1, 0, 2)] == \
        [True, False, False, False]
    assert mine.report() == ref.report() == {
        "nan_rows": 1, "page_corruptions": 2, "kernel_faults": 1,
        "slow_steps": 1, "denied_admissions": 1}


# ----------------------------------------------------------------------
# quarantine: a NaN row, a poisoned page
# ----------------------------------------------------------------------

def test_nan_row_quarantines_its_slot_as_the_jax_engine(model):
    """Slot 0's row is NaN at decode step 2: its request ends there
    (3 tokens, the error naming the step), the others run on, the one
    admitted into the freed slot too, each as served alone."""
    _, _, cfg, params = model
    prompts, gens = _prompts(cfg, [12, 16, 10], seed=11), [6, 6, 5]
    eng, reqs, rep = _side_by_side(
        model, dict(nan_rows={2: 0}), _submit_all(prompts, gens),
        max_slots=2, max_len=32)
    bad = reqs[0]
    assert bad.status == QUARANTINED and len(bad.generated) == 3
    assert bad.error == "non-finite logits at decode step 2"
    assert rep["quarantined"] == 1 and rep["n_finished"] == 2
    assert rep["faults_injected"]["nan_rows"] == 1 and rep["goodput"] < 1.0
    for req, p, g in zip(reqs[1:], prompts[1:], gens[1:]):
        assert req.status == FINISHED
        assert req.generated == _alone(cfg, params, p, g)
    _consistent(eng, rep)


@pytest.mark.parametrize("quant_kv", ["off", "int8"])
def test_page_corruption_quarantines_through_attention(model, quant_kv):
    """Slot 1's write page poisoned before decode step 2 (K and V on a
    bf16 pool, their scales on an int8 pool) ends its request through
    the attention math; the other stream is its own alone and every page
    comes back."""
    _, _, cfg, params = model
    prompts = _prompts(cfg, [10, 14], seed=23)
    eng, reqs, rep = _side_by_side(
        model, dict(corrupt_pages={2: 1}), _submit_all(prompts, [6, 6]),
        kv_layout="paged", quant_kv=quant_kv, max_slots=2, max_len=32,
        page_size=8)
    assert [r.status for r in reqs] == [FINISHED, QUARANTINED]
    assert reqs[1].error == "non-finite logits at decode step 2"
    assert reqs[0].generated == _alone(cfg, params, prompts[0], 6,
                                       kv_layout="paged", quant_kv=quant_kv,
                                       page_size=8)
    assert rep["faults_injected"]["page_corruptions"] == 1
    assert (eng.pool.refcount == 0).all() and eng.pool.n_reserved == 0
    _consistent(eng, rep)


def test_dense_slot_corruption_as_the_jax_engine(model):
    """On the dense cache the slot's rows of every float leaf are
    poisoned, in place in the tensors the step reads."""
    _, _, cfg, _ = model
    prompts = _prompts(cfg, [10, 14], seed=29)
    eng, reqs, rep = _side_by_side(
        model, dict(corrupt_pages={3: 0}), _submit_all(prompts, [6, 6]),
        max_slots=2, max_len=32)
    assert [r.status for r in reqs] == [QUARANTINED, FINISHED]
    _consistent(eng, rep)


# ----------------------------------------------------------------------
# a denied admission: preempt a lower priority, or defer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("vip_priority", [1, 0])
def test_denied_admission_as_the_jax_engine(model, vip_priority):
    """Admission 1 sees an exhausted pool. A higher-priority head
    preempts the victim (its pages back), which resumes into its
    uninterrupted stream; an equal-priority head waits instead."""
    _, _, cfg, params = model
    prompts = _prompts(cfg, [12, 10], seed=31)

    def run(eng, tick):
        victim = eng.submit(prompts[0], 8, priority=0)
        for _ in range(3):
            eng.step()
            tick()
        assert victim.status == ACTIVE and len(victim.generated) == 4
        head = eng.submit(prompts[1], 4, arrival_time=3.0,
                          priority=vip_priority)
        _drive(eng, tick)
        return [victim, head]

    eng, (victim, head), rep = _side_by_side(
        model, dict(deny_admissions=(1,)), run, kv_layout="paged",
        max_slots=2, max_len=32, page_size=8, preempt_backoff=1.5)
    assert rep["preempted"] == victim.preemptions == vip_priority
    assert rep["faults_injected"]["denied_admissions"] == 1
    assert victim.status == head.status == FINISHED
    kw = dict(kv_layout="paged", page_size=8)
    assert victim.generated == _alone(cfg, params, prompts[0], 8, **kw)
    assert head.generated == _alone(cfg, params, prompts[1], 4, **kw)
    assert (eng.pool.refcount == 0).all() and eng.pool.n_reserved == 0
    _consistent(eng, rep)


# ----------------------------------------------------------------------
# kernel faults: retry, rebuild, crash
# ----------------------------------------------------------------------

def test_kernel_faults_rebuild_the_steps_as_the_jax_engine_degrades(
        model, monkeypatch):
    """Faults at steps 1 and 3 with a threshold of 2: the first is retried,
    the second rebuilds the steps first (`degraded`, one RuntimeWarning
    that names the rebuild), and the trace completes with every stream
    its own alone."""
    _, _, cfg, params = model
    prompts = _prompts(cfg, [10, 13], seed=41)
    monkeypatch.setattr(E, "_REBUILD_WARNED", False)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng, reqs, rep = _side_by_side(
            model, dict(kernel_fail_steps=(1, 3)),
            _submit_all(prompts, [5, 5]), max_slots=2, max_len=32,
            kernel_fault_threshold=2)
    mine = [x for x in w if "rebuilt its captured steps" in str(x.message)]
    assert len(mine) == 1 and mine[0].category is RuntimeWarning
    assert "xla" not in str(mine[0].message)
    assert rep["degraded"] and rep["kernel_faults"] == 2
    assert rep["crashed_steps"] == 0 and rep["n_finished"] == 2
    assert eng._step == eng._decode_fn     # the CPU binds the function again
    for req, p in zip(reqs, prompts):
        assert req.generated == _alone(cfg, params, p, 5)
    _consistent(eng, rep)


def test_one_transient_fault_is_retried_without_a_rebuild(model):
    _, _, cfg, params = model
    prompts = _prompts(cfg, [10], seed=43)
    _, reqs, rep = _side_by_side(model, dict(kernel_fail_steps=(2,)),
                                 _submit_all(prompts, [6]), max_slots=1,
                                 max_len=32)
    assert rep["kernel_faults"] == 1 and not rep["degraded"]
    assert rep["crashed_steps"] == 0
    assert reqs[0].generated == _alone(cfg, params, prompts[0], 6)


def test_no_retries_left_crashes_the_step_as_the_jax_engine(model):
    """max_step_retries=0: the scripted fault raises out of run(), one
    crashed step, one fault, in both engines."""
    jcfg, jparams, cfg, params = model
    prompts = _prompts(cfg, [10], seed=47)
    script = dict(kernel_fail_steps=(0, 1))
    jeng = _jax(jcfg, jparams, fault_injector=JaxInjector(**script),
                max_slots=1, max_len=32, max_step_retries=0)
    jeng.submit(prompts[0], 4)
    with pytest.raises(JaxKernelFault):
        jeng.run()
    eng = _port(cfg, params, fault_injector=FaultInjector(**script),
                max_slots=1, max_len=32, max_step_retries=0)
    req = eng.submit(prompts[0], 4)
    with pytest.raises(SimulatedKernelFault, match="decode step 0"):
        eng.run()
    assert (eng.crashed_steps, eng.kernel_faults) == \
        (jeng.crashed_steps, jeng.kernel_faults) == (1, 1)
    assert req.generated == jeng.requests[0].generated


# ----------------------------------------------------------------------
# a slow step, and everything at once
# ----------------------------------------------------------------------

def test_slow_step_is_flagged(model):
    """A step that sleeps 0.5 s is a straggler of the port's detector;
    the JAX engine runs the same script to the same streams."""
    _, _, cfg, _ = model
    prompts = _prompts(cfg, [8], seed=71)
    eng, _, rep = _side_by_side(model, dict(slow_steps={5: 0.5}),
                                _submit_all(prompts, [8]), max_slots=1,
                                max_len=32)
    assert rep["faults_injected"]["slow_steps"] == 1
    assert rep["straggler_steps"] >= 1
    assert any(step == 5 for step, _, _ in eng.straggler.flagged)


def test_combined_chaos_as_the_jax_engine(model):
    """A NaN row, a kernel fault and a denied admission in one paged run,
    and a waiter cancelled: the same statuses, streams and counters as
    the JAX engine, every page back."""
    _, _, cfg, _ = model
    prompts = _prompts(cfg, [12, 10, 14, 10, 8], seed=73)

    def run(eng, tick):
        reqs = [eng.submit(p, 5, priority=i % 2, deadline=60.0)
                for i, p in enumerate(prompts)]
        eng.step()
        tick()
        eng.cancel(reqs[2].rid)
        _drive(eng, tick)
        return reqs

    eng, reqs, rep = _side_by_side(
        model, dict(nan_rows={4: 1}, kernel_fail_steps=(6,),
                    deny_admissions=(2,)), run, kv_layout="paged",
        max_slots=2, max_len=32, page_size=8, preempt_backoff=1.5)
    assert rep["cancelled"] == 1 and rep["quarantined"] == 1
    assert rep["kernel_faults"] == 1 and rep["crashed_steps"] == 0
    assert rep["n_finished"] == 3
    assert (eng.pool.refcount == 0).all() and eng.pool.n_reserved == 0
    _consistent(eng, rep)


def test_a_draft_with_an_injector_is_refused(model):
    jcfg, jparams, cfg, params = model
    msg = "speculative decoding and the chaos injector"
    with pytest.raises(ValueError, match=msg):
        JaxEngine(jcfg, jparams, max_slots=2, max_len=32, policy=PALLAS,
                  fault_injector=JaxInjector(), draft=(jcfg, jparams))
    with pytest.raises(ValueError, match=msg):
        _port(cfg, params, max_slots=2, max_len=32,
              fault_injector=FaultInjector(), draft=(cfg, params))


# ----------------------------------------------------------------------
# the rebuild's state rule, on a Mamba-2 hybrid
# ----------------------------------------------------------------------

WARMUP_RUNS = 2


def _warming_capture(self, steps):
    """`ServingEngine._capture` as on the card: each step's function runs
    `WARMUP_RUNS` times before it is bound, as CapturedStep's warm-ups
    do before the capture."""
    for name, fn, _ in steps:
        for _ in range(WARMUP_RUNS):
            fn()
        setattr(self, name, fn)


@pytest.fixture(scope="module")
def zamba2():
    cfg = dataclasses.replace(get_config("zamba2-1.2b", reduced=True),
                              dtype="float32")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lb = params["hybrid"]["lora_b"]
    params["hybrid"]["lora_b"] = torch.randn(
        lb.shape, generator=torch.Generator().manual_seed(1)) \
        * lb.shape[1] ** -0.5
    prompts = _prompts(cfg, [13, 21, 9], seed=5)
    return cfg, params, prompts


def _zamba2_streams(zamba2, script=None):
    cfg, params, prompts = zamba2
    eng = ServingEngine(cfg, params, max_slots=2, max_len=40, device="cpu",
                        fault_injector=script and FaultInjector(**script))
    reqs = [eng.submit(p, 8) for p in prompts]
    rep = eng.run()
    return [r.generated for r in reqs], rep


def test_hybrid_kernel_faults_keep_the_fault_free_streams(zamba2,
                                                         monkeypatch):
    """A reduced zamba2 with faults at steps 1 and 4: the rebuild falls
    with both slots busy. With the card's warm-ups run at the rebuild,
    the streams are the fault-free run's: no KV row is written at
    position -1 and the Mamba state is put back. Without putting it back
    the warm-ups move it, and a stream changes."""
    want, _ = _zamba2_streams(zamba2)
    monkeypatch.setattr(E, "_REBUILD_WARNED", True)
    got, rep = _zamba2_streams(zamba2, dict(kernel_fail_steps=(1, 4)))
    assert rep["kernel_faults"] == 2 and rep["degraded"]
    assert got == want
    monkeypatch.setattr(ServingEngine, "_capture", _warming_capture)
    got, rep = _zamba2_streams(zamba2, dict(kernel_fail_steps=(1, 4)))
    assert rep["degraded"] and got == want
    monkeypatch.setattr(ServingEngine, "_recurrent_leaves", lambda self: [])
    moved, _ = _zamba2_streams(zamba2, dict(kernel_fail_steps=(1, 4)))
    assert moved != want


# ----------------------------------------------------------------------
# the CLI's --chaos-* flags
# ----------------------------------------------------------------------

CHAOS_FLAGS = dict(chaos_nan_step=3, chaos_nan_slot=1, chaos_corrupt_step=5,
                   chaos_corrupt_slot=0, chaos_kernel_steps="1,4",
                   chaos_slow_steps="6,7", chaos_slow_seconds=0.0,
                   chaos_deny_admissions="2")


@pytest.mark.parametrize("flags", [CHAOS_FLAGS, dict(
    CHAOS_FLAGS, chaos_nan_step=-1, chaos_corrupt_step=-1,
    chaos_kernel_steps="", chaos_slow_steps="", chaos_deny_admissions="")],
    ids=["armed", "unarmed"])
def test_build_injector_as_the_jax_launcher(flags):
    args = argparse.Namespace(**flags)
    mine, ref = serve.build_injector(args), jserve.build_injector(args)
    if ref is None:
        assert mine is None
        return
    for f in ("nan_rows", "corrupt_pages", "kernel_fail_steps",
              "slow_steps", "deny_admissions"):
        assert getattr(mine, f) == getattr(ref, f), f


def test_chaos_cli_survives_and_checks_the_finished_streams(capsys):
    """A reduced paged run under every --chaos-* flag: it survives (no
    crashed step, every request terminal), each scripted fault fired, and
    --check-exact holds the requests that finished to the fault-free
    dense engine."""
    report = serve.main([
        "--reduced", "--device", "cpu", "--requests", "8", "--max-slots",
        "2", "--kv-layout", "paged", "--page-size", "8",
        "--chaos-nan-step", "3", "--chaos-corrupt-step", "8",
        "--chaos-corrupt-slot", "1", "--chaos-kernel-steps", "1,4",
        "--chaos-slow-steps", "6", "--chaos-slow-seconds", "0",
        "--chaos-deny-admissions", "2", "--check-exact"])
    out = capsys.readouterr().out
    assert report["crashed_steps"] == 0 and report["degraded"]
    assert report["faults_injected"] == {
        "nan_rows": 1, "page_corruptions": 1, "kernel_faults": 2,
        "slow_steps": 1, "denied_admissions": 1}
    assert report["quarantined"] == 2 and report["n_finished"] == 6
    assert "chaos: survived 6 injected fault(s)" in out
    assert "check-exact: 6 token streams match" in out
