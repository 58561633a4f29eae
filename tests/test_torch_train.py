"""The port's training path on the CPU (the kernels' plain versions)
against the JAX package under `Policy(backend="pallas", interpret=True)`,
on the same numpy inputs and the same weights and optimizer state (the
JAX ones, bridged leaf for leaf): the attention forward/backward pair,
the GEMM chokepoint's gradients, the loss, and whole AdamW train steps.

Both sides run in float32 on the reduced qwen3 (2 layers, d_model 64,
4/2 heads of 16) with a vocab of 250 padded to 256, so the pad classes'
mask (-1e30 logits, no gradient) runs. Stated tolerances, each the order
of a sum
taken in another order, scaled to the values compared:
  * kernels and GEMM gradients: atol = rtol = 1e-5;
  * logits and gradients of the whole model: atol = 1e-4, rtol = 1e-5;
  * loss and grad norm: rtol = 1e-5;
  * params after AdamW steps: atol = 2e-6 (0.2% of a step of lr = 1e-3)
    on all but 1 in 1,000 entries of a leaf, and atol = lr on every
    entry. Adam moves an entry by lr * m / (sqrt(v) + eps); where an
    entry's gradient lies at the f32 noise of its sum (-1.7e-8 in JAX,
    -4.7e-9 here, against a largest gradient of 0.07 in that leaf: 2 of
    8,192 entries of wq at step 0), that noise decides its step.

None of these tests changes process-wide state: the JAX policy is passed
to each call or entered as a scope, jax's x64 flag and torch's default
dtype and seeds are left alone, and the JAX package's warn-once set is
restored after each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import gemm as jgemm
from repro.core import policy as jpolicy
from repro.core.policy import Policy
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.training import train_loop as JTL
from repro_torch.bridge import adamw_state_from_numpy, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import gemm
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.training import train_loop as TL

PALLAS = Policy(backend="pallas", interpret=True)
KTOL = dict(atol=1e-5, rtol=1e-5)
MTOL = dict(atol=1e-4, rtol=1e-5)
SEQ, BATCH = 32, 2


@pytest.fixture(autouse=True)
def _keep_warn_once_state():
    """The JAX attention warns once per process under an ambient pallas
    scope; put its warn-once set back as it was."""
    saved = set(jpolicy._warned)
    yield
    jpolicy._warned.clear()
    jpolicy._warned.update(saved)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), **(tol or KTOL))


# -- the attention pair -------------------------------------------------

def _flat(x):
    b, t, h, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)


def _unflat(x, b):
    bh, t, d = x.shape
    return np.asarray(x).reshape(b, bh // b, t, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("window", [None, 16])
def test_attention_plain_versions_match_pallas(window):
    """The plain forward and backward against the Pallas kernels in
    interpret mode (16-row blocks, so the causal and window block skips
    run) and against the closed-form `attention_bwd_ref`: causal, GQA
    group of 2, T = 48."""
    b, t, h, hkv, d = 2, 48, 4, 2, 16
    rng = np.random.default_rng(0)
    q, do = (rng.standard_normal((b, t, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, t, hkv, d)).astype(np.float32)
            for _ in range(2))
    jo, jlse = jfa.flash_attention(
        _flat(q), _flat(k), _flat(v), group=h // hkv, causal=True,
        window=window, bq=16, bk=16, interpret=True, return_lse=True)
    jo = _unflat(jo, b)
    o, lse = ops.flash_attention_fwd(_t(q), _t(k), _t(v), causal=True,
                                     window=window)
    _close(o, jo)
    _close(lse, np.asarray(jlse).reshape(b, h, t))

    jdq, jdk, jdv = jfa.flash_attention_bwd(
        _flat(q), _flat(k), _flat(v), _flat(jo), _flat(do), jlse,
        group=h // hkv, causal=True, window=window, bq=16, bk=16,
        interpret=True)
    # the Pallas kernel's dK/dV are per query head; the JAX ops sum them
    jdk = _unflat(jdk, b).reshape(b, t, hkv, h // hkv, d).sum(3)
    jdv = _unflat(jdv, b).reshape(b, t, hkv, h // hkv, d).sum(3)
    got = ops.flash_attention_bwd(_t(q), _t(k), _t(v), o, _t(do), lse,
                                  causal=True, window=window)
    closed = jref.attention_bwd_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(jo),
        jnp.asarray(do), jnp.asarray(jlse).reshape(b, h, t), causal=True,
        window=window)
    for mine, pallas, ref in zip(got, (_unflat(jdq, b), jdk, jdv), closed):
        _close(mine, pallas)
        _close(mine, ref)


def test_attention_backward_is_autograd_of_its_forward():
    """On a shape with rows that see no key (not causal, a window of 4,
    Tk < Tq), the plain backward is the gradient of the plain forward:
    those rows give o = 0 and no gradient, where JAX's dense
    `attention_ref` would give them uniform weights."""
    rng = np.random.default_rng(1)
    q = _t(rng.standard_normal((2, 40, 4, 16)).astype(np.float32))
    k, v = (_t(rng.standard_normal((2, 20, 2, 16)).astype(np.float32))
            for _ in range(2))
    do = _t(rng.standard_normal((2, 40, 4, 16)).astype(np.float32))
    qkv = [x.requires_grad_() for x in (q, k, v)]
    o, lse = ops.flash_attention_fwd(*qkv, causal=False, window=4)
    assert torch.equal(lse[:, :, 23:], torch.full_like(lse[:, :, 23:], 1e30))
    assert not o[:, 23:].any()
    want = torch.autograd.grad(o, qkv, do)
    got = ops.flash_attention_bwd(q.detach(), k.detach(), v.detach(),
                                  o.detach(), do, lse, causal=False, window=4)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, **KTOL)


# -- the GEMM chokepoint's autograd ---------------------------------------

def _vjp_both(jfn, fn, primals, rng):
    """(outputs, cotangents) of jax.vjp(jfn) and torch autograd of fn on
    the same primals and the same random output cotangent."""
    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, primals))
    g = rng.standard_normal(jout.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(g))
    ts = [_t(p).requires_grad_() for p in primals]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, _t(g))
    return (out, jout), zip(grads, jgrads)


def test_matmul_gradients_match_jax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((2, 5, 24)).astype(np.float32)
    b = rng.standard_normal((24, 40)).astype(np.float32) / 5
    (out, jout), grads = _vjp_both(
        lambda a_, b_: jgemm.matmul(a_, b_, policy=PALLAS),
        gemm.matmul, (a, b), rng)
    _close(out, jout)
    for x, y in grads:
        _close(x, y)


@pytest.mark.parametrize("epilogue", ["none", "bias", "bias_gelu",
                                      "bias_silu", "residual"])
def test_dense_gradients_match_jax(epilogue):
    rng = np.random.default_rng(3)
    m, k, n = 12, 32, 24
    prim = [rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32) / 6]
    kw = {"activation": {"bias_gelu": "gelu",
                         "bias_silu": "silu"}.get(epilogue)}
    if epilogue.startswith("bias"):
        prim.append(rng.standard_normal((n,)).astype(np.float32))
    elif epilogue == "residual":
        prim.append(rng.standard_normal((m, n)).astype(np.float32))

    def call(dense, x, w, e=None, **extra):
        if epilogue == "residual":
            return dense(x, w, residual=e, **kw, **extra)
        return dense(x, w, e, **kw, **extra)

    (out, jout), grads = _vjp_both(
        lambda *p: call(jgemm.dense, *p, policy=PALLAS),
        lambda *p: call(gemm.dense, *p), prim, rng)
    _close(out, jout)
    for x, y in grads:
        _close(x, y)


def test_gated_mlp_gradients_match_jax():
    rng = np.random.default_rng(4)
    prim = [rng.standard_normal((2, 6, 32)).astype(np.float32),
            rng.standard_normal((32, 48)).astype(np.float32) / 6,
            rng.standard_normal((32, 48)).astype(np.float32) / 6]
    (out, jout), grads = _vjp_both(
        lambda *p: jgemm.gated_mlp(*p, policy=PALLAS), gemm.gated_mlp,
        prim, rng)
    _close(out, jout)
    for x, y in grads:
        _close(x, y)


# -- the model, the loss and the train step --------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", reduced=True),
                               dtype="float32", vocab=250)
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              dtype="float32", vocab=250)
    assert cfg.padded_vocab == jcfg.padded_vocab == 256
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 2, 3), clip_norm=1.0)
    opt = adamw.AdamW(lr=adamw.cosine_schedule(1e-3, 2, 3), clip_norm=1.0)
    jstate = JTL.init_state(jcfg, jopt, jax.random.PRNGKey(0))
    data = JSyntheticLM(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH, seed=0)
    batches = [data.batch_at(i) for i in range(3)]

    def reference(p, b):
        """JAX's logits, (loss, metrics) and gradients on one batch."""
        logits, _ = JM.forward(jcfg, p, b)
        return logits, jax.value_and_grad(
            lambda q: JM.loss_fn(jcfg, q, b), has_aux=True)(p)

    with PALLAS.scope():
        ref = jax.jit(reference)(jstate.params,
                                 jax.tree.map(jnp.asarray, batches[0]))
    return dict(jcfg=jcfg, cfg=cfg, jopt=jopt, opt=opt, jstate=jstate,
                batches=batches, ref=ref)


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _leaves_by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_trees(port_tree, jax_tree, **tol):
    want = _leaves_by_path(jax_tree)
    got = _leaves_by_path(jax.tree.map(lambda t: t.detach().numpy(),
                                       port_tree))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


def test_forward_and_loss_match_jax(model):
    jlogits, ((jloss, jmet), _) = model["ref"]
    batch = model["batches"][0]
    params = _bridge(model["jstate"].params)
    logits = M.forward(model["cfg"], params, _torch_batch(batch))
    _close(logits, jlogits, **MTOL)
    loss, met = M.loss_fn(model["cfg"], params, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(met["tokens"]) == int(jmet["tokens"]) == BATCH * (SEQ - 1)
    assert set(met) == set(jmet)


def test_training_attention_takes_the_fused_pair_and_prefill_does_not(
        model, monkeypatch):
    """The cache-less forward routes every layer's attention to the flash
    forward and its backward to flash_attention_bwd; prefill into a cache
    keeps the chunked path."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ops.flash_attention_fwd, ops.flash_attention_bwd

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ops, "flash_attention_fwd", count("fwd", fwd))
    monkeypatch.setattr(ops, "flash_attention_bwd", count("bwd", bwd))
    cfg, params = model["cfg"], _bridge(model["jstate"].params)
    batch = _torch_batch(model["batches"][0])
    M.prefill(cfg, params, batch, M.init_cache(cfg, BATCH, SEQ, "cpu"))
    assert calls == {"fwd": 0, "bwd": 0}
    TL._loss_and_grads(cfg, params, batch)
    assert calls == {"fwd": cfg.n_layers, "bwd": cfg.n_layers}


def test_gradients_match_jax_leaf_for_leaf(model):
    _, (_, jgrads) = model["ref"]
    _, _, grads = TL._loss_and_grads(model["cfg"],
                                     _bridge(model["jstate"].params),
                                     _torch_batch(model["batches"][0]))
    _close_trees(grads, jgrads, **MTOL)


def test_three_train_steps_match_jax(model):
    """Steps 0 and 1 whole, step 2 in two microbatches: the loss and grad
    norm of each, and the params and AdamW state after them."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jstate = model["jstate"]
    state = TL.TrainState(_bridge(jstate.params),
                          adamw_state_from_numpy(
                              jax.tree.map(np.asarray, jstate.opt), "cpu"))
    jsteps = {a: jax.jit(JTL.make_train_step(jcfg, model["jopt"], accum=a,
                                             policy=PALLAS)) for a in (1, 2)}
    for i, accum in enumerate((1, 1, 2)):
        step = TL.make_train_step(cfg, model["opt"], accum=accum)
        batch = model["batches"][i]
        jstate, jmet = jsteps[accum](jstate, jax.tree.map(jnp.asarray, batch))
        state, met = step(state, _torch_batch(batch))
        for key in ("loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       rtol=1e-5, err_msg=f"step {i} {key}")
        assert int(met["tokens"]) == int(jmet["tokens"])
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    want = _leaves_by_path(jstate.params)
    got = _leaves_by_path(jax.tree.map(lambda t: t.numpy(), state.params))
    for key in want:
        err = np.abs(got[key] - want[key])
        assert err.max() <= 1e-3, (key, err.max())
        assert (err > 2e-6).mean() <= 1e-3, (key, int((err > 2e-6).sum()))
    _close_trees(state.opt.m, jstate.opt.m, **MTOL)
    _close_trees(state.opt.v, jstate.opt.v, atol=1e-7, rtol=1e-4)


# -- optimizer, schedule, data, launcher ------------------------------------

def test_synthetic_batches_equal_jax():
    for seed, step in ((0, 0), (0, 5), (3, 1)):
        mine = SyntheticLM(vocab=256, seq_len=32, batch=2, seed=seed)
        ref = JSyntheticLM(vocab=256, seq_len=32, batch=2, seed=seed)
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_cosine_schedule_matches_jax():
    mine = adamw.cosine_schedule(3e-4, 5, 20)
    ref = jadamw.cosine_schedule(3e-4, 5, 20)
    for step in range(0, 25):
        np.testing.assert_allclose(
            float(mine(torch.tensor(step, dtype=torch.int32))),
            float(ref(jnp.int32(step))), rtol=1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(state_dtype):
    """Three updates of a toy tree (a matrix, decayed, and a vector, not),
    with clipping active on the first."""
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "n": {"scale": rng.standard_normal((5,)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p, s=s: (rng.standard_normal(p.shape) * s)
                          .astype(np.float32), params) for s in (3.0, 0.1, 0.2)]
    kw = dict(clip_norm=1.0, state_dtype=state_dtype)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-2, 1, 3), **kw)
    opt = adamw.AdamW(lr=adamw.cosine_schedule(1e-2, 1, 3), **kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    p = params_from_numpy(params, "cpu")
    s = opt.init(p)
    for g in grads:
        jp, js, jnorm = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        p, s, norm = opt.update(params_from_numpy(g, "cpu"), s, p)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    _close_trees(p, jp, atol=1e-6, rtol=1e-6)
    for mine, ref in ((s.m, js.m), (s.v, js.v)):
        _close_trees(jax.tree.map(lambda t: t.float(), mine),
                     jax.tree.map(lambda x: x.astype(jnp.float32), ref),
                     atol=1e-7, rtol=1e-6)


def test_train_cli_runs_on_the_cpu(capsys):
    losses = train_cli.main(["--reduced", "--device", "cpu", "--steps", "2",
                             "--batch", "2", "--seq", "16", "--warmup", "1",
                             "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "final loss" in out


def test_train_cli_without_device_raises_where_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--reduced", "--steps", "1"])


def test_init_state_takes_the_port_param_tree():
    cfg = get_config("qwen3-0.6b", reduced=True)
    opt = adamw.AdamW()
    state = TL.init_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(x.shape) for x in leaves(state.opt.m)] == \
        [tuple(x.shape) for x in leaves(state.params)]
    assert int(state.opt.step) == 0
