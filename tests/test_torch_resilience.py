"""Resilient training in the port against the JAX package: the token
corpus, the checkpointer, the supervisor and the train launcher's
--ckpt-dir / --ckpt-every / --fail-at, on qwen3-0.6b's reduced config on
the CPU.

  * the twins of tests/test_substrate.py's corpus, checkpoint,
    supervisor, straggler and elastic-mesh tests, on the port's modules;
  * `MemmapCorpus` batches equal the reference's for several (step,
    shard, n_shards);
  * a restore writes into the state's own tensors, and is bit for bit,
    within the port and across both packages, both ways (the same
    manifest and the same .npy bytes for the same tree, bf16 leaves as
    raw uint16 views);
  * an async save under a donated step: the checkpoint is the state as
    it was at the save, after the next steps rewrote its tensors;
  * the launcher with --fail-at 6 --ckpt-every 4 runs its steps in the
    JAX launcher's order for the same arguments, and its replayed losses
    and final state equal an uninterrupted run's, bit for bit; a run
    resumed by a second CLI call ends in the same state as one call.

Every file is written under pytest's tmp_path; every async save is
waited for before its test ends.
"""

import json
import os
import re
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core.policy as jpolicy
from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import MemmapCorpus as JMemmapCorpus
from repro.launch import train as jtrain_cli
from repro.optim import adamw as jadamw
from repro.training import train_loop as JTL
from repro_torch.bridge import adamw_state_from_numpy, params_from_numpy
from repro_torch.checkpoint import Checkpointer, flatten
from repro_torch.configs import get_config
from repro_torch.data.pipeline import MemmapCorpus, SyntheticLM, write_corpus
from repro_torch.distributed import (FailureInjector, SimulatedFailure,
                                     StragglerDetector, Supervisor,
                                     elastic_mesh_shape)
from repro_torch.launch import train as train_cli
from repro_torch.optim.adamw import AdamW
from repro_torch.training import train_loop as TL

CLI = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
       "--warmup", "1", "--log-every", "1"]


@pytest.fixture(autouse=True)
def _keep_warn_once_state():
    """The JAX attention warns once per process under an ambient pallas
    scope; put its warn-once set back as it was."""
    saved = set(jpolicy._warned)
    yield
    jpolicy._warned.clear()
    jpolicy._warned.update(saved)


def _equal_trees(a, b):
    la, lb = flatten(a), flatten(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), i


def _clone_any(tree):
    if tree is None:                    # TrainState.ef without compression
        return None
    if isinstance(tree, dict):
        return {k: _clone_any(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_clone_any(v) for v in tree))
    return tree.clone()


# -- the twins of tests/test_substrate.py ---------------------------------

def test_data_determinism_and_shards():
    d = SyntheticLM(vocab=1000, seq_len=16, batch=4, seed=7)
    b1 = d.batch_at(3, shard=0, n_shards=2)
    b2 = d.batch_at(3, shard=0, n_shards=2)
    b3 = d.batch_at(3, shard=1, n_shards=2)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], b3["tokens"])
    assert (b1["labels"][:, :-1] == b1["tokens"][:, 1:]).all()
    assert (b1["labels"][:, -1] == -1).all()


def test_memmap_corpus(tmp_path):
    path = str(tmp_path / "corpus.bin")
    write_corpus(path, np.arange(10_000) % 500)
    d = MemmapCorpus(path=path, vocab=500, seq_len=16, batch=4)
    b = d.batch_at(0)
    assert b["tokens"].shape == (4, 16)
    assert b["tokens"].max() < 500
    np.testing.assert_array_equal(d.batch_at(1)["tokens"],
                                  d.batch_at(1)["tokens"])


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_memmap_batches_equal_reference(tmp_path, dtype):
    """Both packages' MemmapCorpus on one file (written by the port) give
    the same batches at every (step, shard, n_shards), past the file's
    last span too (it wraps); n_batches alike."""
    path = str(tmp_path / "corpus.bin")
    tokens = np.random.default_rng(0).integers(0, 70_000, 9_000)
    write_corpus(path, tokens, dtype=dtype)
    kw = dict(path=path, vocab=1000, seq_len=31, batch=3, dtype=dtype)
    d, jd = MemmapCorpus(**kw), JMemmapCorpus(**kw)
    assert d.n_batches() == jd.n_batches() == 9_000 // (3 * 32)
    for step, shard, n in [(0, 0, 1), (1, 0, 1), (5, 1, 2), (7, 3, 4),
                           (93, 0, 1), (200, 2, 3)]:
        got, want = d.batch_at(step, shard, n), jd.batch_at(step, shard, n)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_checkpoint_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((2,), dtype=torch.bfloat16)}}
    for step in (10, 20, 30):
        ck.save(step, {"a": tree["a"] * step,
                       "b": {"c": tree["b"]["c"] * step}})
    assert ck.steps() == [20, 30]          # keep=2 rotated
    like = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(
        2, dtype=torch.bfloat16)}}
    out = ck.restore(30, like)
    assert out is like
    torch.testing.assert_close(out["a"], tree["a"] * 30, rtol=0, atol=0)
    assert torch.equal(out["b"]["c"], tree["b"]["c"] * 30)


def test_checkpoint_async_and_atomic(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    tree = {"w": torch.ones((64, 64))}
    ck.save(1, tree, blocking=False)
    ck.wait()
    assert ck.latest_step() == 1
    # a stale tmp dir must never be listed as a checkpoint
    os.makedirs(str(tmp_path / "step_99.tmp"), exist_ok=True)
    assert 99 not in ck.steps()


def _reduced():
    cfg = get_config("qwen3-0.6b", reduced=True)
    opt = AdamW(lr=1e-3)
    return cfg, opt, TL.init_state(cfg, opt, torch.Generator().manual_seed(0),
                                   "cpu")


def _batch(data, step):
    return {k: torch.from_numpy(v).long()
            for k, v in data.batch_at(step).items()}


def test_supervisor_recovers_from_injected_failure(tmp_path):
    cfg, opt, state = _reduced()
    step_fn_ = TL.make_train_step(cfg, opt, donate=True)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=2)

    ck = Checkpointer(str(tmp_path), keep=2)
    sup = Supervisor(ck, max_restarts=2, checkpoint_every=4)
    inj = FailureInjector(fail_at_steps=(6,))
    seen = []

    def step_fn(state, step):
        seen.append(step)
        return step_fn_(state, _batch(data, step))

    state, step = sup.run_resilient(state, step_fn, 10, injector=inj,
                                    on_metrics=lambda *a: None)
    assert step == 10
    assert sup.restarts == 1
    assert 4 in seen and seen.count(5) >= 2   # replayed from checkpoint 4


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    ck = Checkpointer(str(tmp_path))
    sup = Supervisor(ck, max_restarts=1, checkpoint_every=100)

    def bad_step(state, step):
        raise SimulatedFailure("always")

    with pytest.raises(SimulatedFailure):
        sup.run_resilient({}, bad_step, 5)


def test_straggler_detector():
    det = StragglerDetector(threshold=2.0, warmup=1)
    for i in range(5):
        assert not det.observe(i, 0.1)
    assert det.observe(5, 0.5)
    assert len(det.flagged) == 1
    # EWMA not polluted by the straggler
    assert abs(det.ewma - 0.1) < 1e-6


def test_elastic_mesh_shape():
    assert elastic_mesh_shape(512, 16) == (32, 16)
    assert elastic_mesh_shape(496, 16) == (31, 16)   # one host lost
    with pytest.raises(AssertionError):
        elastic_mesh_shape(8, 16)


# -- restore in place, and across both packages ----------------------------

def test_restore_writes_into_the_states_own_tensors(tmp_path):
    """restore copies into `like`'s tensors (the same storage before and
    after) and returns `like`; a leaf stored in another dtype is cast to
    its tensor's; a leaf count or a shape that differs is refused."""
    _, _, state = _reduced()
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state)
    like = TL.init_state(get_config("qwen3-0.6b", reduced=True), AdamW(),
                         torch.Generator().manual_seed(1), "cpu")
    ptrs = [t.data_ptr() for t in flatten(like)]
    out = ck.restore(3, like)
    assert out is like
    assert [t.data_ptr() for t in flatten(like)] == ptrs
    _equal_trees(like, state)
    half = {"w": torch.zeros((4, 4), dtype=torch.bfloat16)}
    ck.save(4, {"w": torch.linspace(-2, 2, 16).reshape(4, 4)})
    assert torch.equal(ck.restore(4, half)["w"],
                       torch.linspace(-2, 2, 16).reshape(4, 4)
                       .to(torch.bfloat16))
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(4, {"w": torch.zeros(4, 4), "x": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(4, {"w": torch.zeros(4, 5)})


def _random_jax_state(jcfg, state_dtype):
    """A JAX TrainState (ef None) of jcfg with random params and
    moments (in `state_dtype`) and step 7."""
    jopt = jadamw.AdamW(lr=1e-3, state_dtype=state_dtype)
    jstate = JTL.init_state(jcfg, jopt, jax.random.PRNGKey(0))
    keys = iter(jax.random.split(jax.random.PRNGKey(5), 1000))
    rand = lambda x, dt: jax.random.normal(next(keys), x.shape, dt)
    m = jax.tree.map(lambda x: rand(x, jnp.dtype(state_dtype)),
                     jstate.opt.m)
    v = jax.tree.map(lambda x: rand(x, jnp.dtype(state_dtype)) ** 2,
                     jstate.opt.v)
    assert jstate.ef is None
    return jstate._replace(opt=jstate.opt._replace(
        step=jnp.asarray(7, jnp.int32), m=m, v=v))


def _port_like(cfg, state_dtype):
    opt = AdamW(state_dtype=state_dtype)
    return TL.init_state(cfg, opt, torch.Generator().manual_seed(3), "cpu")


def _port_of(jstate):
    numpy = jax.tree.map(np.asarray, jstate)
    return TL.TrainState(params_from_numpy(numpy.params, "cpu"),
                         adamw_state_from_numpy(numpy.opt, "cpu"))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_restore_across_packages_bit_for_bit(tmp_path, state_dtype):
    """A JAX TrainState(params, opt, ef=None) saved by the reference's
    Checkpointer restores into the port's TrainState(params, opt) bit for
    bit, and the port's state saved by the port restores into the
    reference's, bit for bit; both packages write the same manifest
    (shapes, dtypes, raw views, leaf count) and the same .npy bytes for
    the same state."""
    jcfg = jax_get_config("qwen3-0.6b", reduced=True)
    cfg = get_config("qwen3-0.6b", reduced=True)
    jstate = _random_jax_state(jcfg, state_dtype)
    want = _port_of(jstate)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    JCheckpointer(str(jdir)).save(7, jstate)

    like = _port_like(cfg, state_dtype)
    Checkpointer(str(jdir)).restore(7, like)
    _equal_trees(like, want)
    assert like.opt.step.dtype == torch.int32 and int(like.opt.step) == 7

    Checkpointer(str(pdir)).save(7, want)
    back = JCheckpointer(str(pdir)).restore(7, JTL.init_state(
        jcfg, jadamw.AdamW(state_dtype=state_dtype),
        jax.random.PRNGKey(9)))
    got, exp = jax.tree.leaves(back), jax.tree.leaves(jstate)
    assert len(got) == len(exp)
    for a, b in zip(got, exp):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()

    mj = json.loads((jdir / "step_7" / "manifest.json").read_text())
    mp = json.loads((pdir / "step_7" / "manifest.json").read_text())
    for key in ("step", "n_leaves", "shapes", "dtypes", "raw_views", "spec"):
        assert mp[key] == mj[key], key
    if state_dtype == "bfloat16":
        assert "bfloat16" in mp["raw_views"]
        assert np.load(pdir / "step_7" / "arr_0.npy").dtype != \
            ml_dtypes.bfloat16
    for i in range(mp["n_leaves"]):
        assert (jdir / "step_7" / f"arr_{i}.npy").read_bytes() == \
            (pdir / "step_7" / f"arr_{i}.npy").read_bytes(), i


def test_async_save_under_a_donated_step_keeps_its_snapshot(tmp_path):
    """Steps 0-3 donated, an async save of step 4, steps 4-5 donated
    (their tensors rewritten in place, the same storage): the checkpoint
    equals the state as it was at the save, bit for bit."""
    cfg, opt, state = _reduced()
    step_fn = TL.make_train_step(cfg, opt, donate=True)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, batch=2)
    for i in range(4):
        state, _ = step_fn(state, _batch(data, i))
    snap = _clone_any(state)
    ptrs = [t.data_ptr() for t in flatten(state)]
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(4, state, blocking=False)
    for i in (4, 5):
        state, _ = step_fn(state, _batch(data, i))
    ck.wait()
    assert [t.data_ptr() for t in flatten(state)] == ptrs
    assert not torch.equal(state.params["embed"]["w"],
                           snap.params["embed"]["w"])
    like = _port_like(cfg, "float32")
    _equal_trees(ck.restore(4, like), snap)


# -- the launcher -----------------------------------------------------------

def _step_lines(out):
    return [(int(m.group(1)), m.group(2)) for m in re.finditer(
        r"^step +(\d+) loss (\S+) gnorm", out, re.M)]


def _jax_run_order(tmp_path, monkeypatch, capsys, args):
    """The steps the JAX launcher runs, in order, for `args` (its policy
    setter held off: it would change the process's default policy)."""
    monkeypatch.setattr(jpolicy, "set_default_policy", lambda p: None)
    jtrain_cli.main(["--reduced", "--batch", "2", "--seq", "16",
                     "--warmup", "1", "--log-every", "1",
                     "--ckpt-dir", str(tmp_path / "jax"), *args])
    return [s for s, _ in _step_lines(capsys.readouterr().out)]


def test_fail_at_replays_bit_for_bit_in_the_jax_launchers_order(
        tmp_path, monkeypatch, capsys):
    """--steps 8 --ckpt-every 4 --fail-at 6: the run's steps come in the
    JAX launcher's order for the same arguments (0-5, 4-7); the replayed
    steps 4 and 5 give their first losses; the losses are one entry a
    step run; and the state saved at step 8 equals an uninterrupted
    run's, every leaf bit for bit."""
    args = ["--steps", "8", "--ckpt-every", "4"]
    jorder = _jax_run_order(tmp_path, monkeypatch, capsys,
                            args + ["--fail-at", "6"])
    losses = train_cli.main(CLI + args + ["--ckpt-dir", str(tmp_path / "a"),
                                          "--fail-at", "6"])
    out = capsys.readouterr().out
    lines = _step_lines(out)
    assert [s for s, _ in lines] == jorder == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    assert len(losses) == 10
    assert losses[6:8] == losses[4:6]
    assert "done at step 8" in out and "restarts=1" in out
    plain = train_cli.main(CLI + args + ["--ckpt-dir", str(tmp_path / "b")])
    assert plain == losses[:6] + losses[8:]
    like_a = _port_like(get_config("qwen3-0.6b", reduced=True), "float32")
    like_b = _port_like(get_config("qwen3-0.6b", reduced=True), "float32")
    Checkpointer(str(tmp_path / "a")).restore(8, like_a)
    Checkpointer(str(tmp_path / "b")).restore(8, like_b)
    _equal_trees(like_a, like_b)
    assert int(like_a.opt.step) == 8


def test_resume_across_two_cli_calls(tmp_path, capsys):
    """A run of 8 steps saved at 4 and 8; with step 8's checkpoint taken
    away, a second call resumes from step 4, runs steps 4-7 with the first
    call's losses, and saves the first call's step-8 state, bit for
    bit."""
    d = tmp_path / "ck"
    args = CLI + ["--steps", "8", "--ckpt-every", "4", "--ckpt-dir", str(d)]
    first = train_cli.main(args)
    capsys.readouterr()
    shutil.move(str(d / "step_8"), str(tmp_path / "first_8"))
    second = train_cli.main(args)
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 4" in out
    assert [s for s, _ in _step_lines(out)] == [4, 5, 6, 7]
    assert second == first[4:]
    cfg = get_config("qwen3-0.6b", reduced=True)
    a, b = _port_like(cfg, "float32"), _port_like(cfg, "float32")
    Checkpointer(str(d)).restore(8, a)
    os.makedirs(tmp_path / "keep")
    shutil.move(str(tmp_path / "first_8"), str(tmp_path / "keep" / "step_8"))
    Checkpointer(str(tmp_path / "keep")).restore(8, b)
    _equal_trees(a, b)
