"""Training the port's mamba2 (the ssm family) on the CPU against the JAX
package, on the same numpy inputs and the same weights and optimizer
state (the JAX ones, bridged leaf for leaf): the SSD chokepoint's
gradients (`core.ssd._SSD`, whose backward differentiates the plain
chunked scan, as the reference's custom VJP differentiates
`ssd_chunked`), the reduced model's logits and loss (f32 and bf16), its
gradients leaf for leaf, three AdamW steps of two microbatches each, and
rematerialisation, which must give the bits of a step without it.

The JAX side runs jitted under `Policy()` (its SSD scan the plain
`ssd_chunked`, its GEMMs XLA dots), passed to each call. The batches
are 24 tokens long, so the chunk of 16 pads its second chunk with 8
steps of dt = 0, whose gradients must vanish.

Stated tolerances, as `test_torch_ssd.py`, `test_torch_mamba.py` and
`test_torch_train.py` state them:
  * the SSD gradients: rtol 1e-5, atol 1e-5 x the largest |value| of
    each gradient (the same sums in another order);
  * logits: f32 atol = rtol = 1e-4; bf16 2^-4 (atol and rtol) on all but
    1 in 1,000 entries and 2^-3 on every entry (XLA's bf16 elementwise
    ops round at other places than PyTorch's, compounding over the
    layers, at every one of the 24 positions); the loss rtol 1e-5 (f32),
    2^-7 (bf16);
  * gradients of the whole model: atol 1e-4, rtol 1e-5;
  * loss and grad norm of a step: rtol 1e-5; params after the steps:
    atol 2e-6 on all but 1 in 1,000 entries of a leaf and 1e-3 on every
    entry; the moments atol 1e-4 / 1e-7, rtol 1e-5 / 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import ssd as jax_core_ssd
from repro.core.policy import Policy
from repro.data.pipeline import SyntheticLM
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.training import train_loop as JTL
from repro_torch.bridge import adamw_state_from_numpy, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import ssd as core_ssd
from repro_torch.core.tree import leaves, tree_map
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.training import train_loop as TL

ARCH = "mamba2-2.7b"
POLICY = Policy()
SEQ, BATCH = 24, 2
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
MTOL = dict(atol=1e-4, rtol=1e-5)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.detach().float().numpy(), want, rtol=1e-5,
        atol=1e-5 * float(np.abs(want).max()))


# -- the SSD chokepoint's autograd ------------------------------------------

# (L, chunk, initial state, -a range, cotangent of the final state): whole
# chunks; a ragged 50 and 37 padded as mamba_apply pads them; strong
# decays (a = -20, as chip_smoke's phase 3 takes them); y's cotangent alone
SSD_CASES = [(64, 16, False, (0.01, 0.5), True),
             (50, 16, True, (0.01, 0.5), True),
             (37, 8, False, (0.01, 0.5), True),
             (64, 16, True, (20.0, 20.0), True),
             (40, 16, True, (0.01, 0.5), False)]


@pytest.mark.parametrize("l, chunk, with_state, decay, state_ct", SSD_CASES)
def test_ssd_gradients_match_jax_custom_vjp(l, chunk, with_state, decay,
                                            state_ct):
    """The gradients of x, a, b, c and the initial state through
    `core.ssd.ssd`, padded to a chunk multiple with a = 0 and zero x, b
    and c (the pad steps are identities of the recurrence), against
    `jax.vjp` of `repro.core.ssd.ssd` on the same function."""
    b_, h, g, p, n = 2, 4, 2, 8, 16
    rng = np.random.default_rng(l)
    prim = [rng.normal(size=(b_, l, h, p)),
            -rng.uniform(*decay, size=(b_, l, h)),
            rng.normal(size=(b_, l, g, n)) * n ** -0.25,
            rng.normal(size=(b_, l, g, n)) * n ** -0.25,
            rng.normal(size=(b_, h, p, n))]
    prim = [x.astype(np.float32) for x in prim]
    gy = rng.normal(size=(b_, l, h, p)).astype(np.float32)
    gs = rng.normal(size=(b_, h, p, n)).astype(np.float32)
    pad = (-l) % chunk

    def padw(t):
        return jnp.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))

    def jfn(x, a, bm, cm, s0):
        y, s = jax_core_ssd.ssd(*map(padw, (x, a, bm, cm)), chunk,
                                init_state=s0 if with_state else None,
                                policy=POLICY)
        return y[:, :l], s

    (jy, js), vjp = jax.vjp(jax.jit(jfn), *map(jnp.asarray, prim))
    jgrads = vjp((jnp.asarray(gy), jnp.asarray(gs if state_ct
                                               else np.zeros_like(gs))))

    ts = [torch.from_numpy(x).requires_grad_() for x in prim]
    padded = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
              for t in ts[:4]]
    y, s = core_ssd.ssd(*padded, chunk,
                        init_state=ts[4] if with_state else None)
    y = y[:, :l]
    _close(y, jy)
    _close(s, js)
    outs, cts = [y], [torch.from_numpy(gy)]
    if state_ct:
        outs.append(s)
        cts.append(torch.from_numpy(gs))
    grads = torch.autograd.grad(outs, ts if with_state else ts[:4], cts)
    for got, want in zip(grads, jgrads):
        assert torch.isfinite(got).all()
        _close(got, want)


def test_ssd_function_records_only_when_autograd_would():
    """Serving (no operand that requires a gradient, or grad mode off)
    runs the dispatcher bare; a recorded call goes through `_SSD`, whose
    output feeds its backward and whose values are the dispatcher's."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1, 32, 4, 8)).astype(np.float32))
    a = torch.from_numpy(-rng.uniform(0.01, 0.5, (1, 32, 4))
                         .astype(np.float32))
    bm, cm = (torch.from_numpy(rng.normal(size=(1, 32, 2, 16))
                               .astype(np.float32)) for _ in range(2))
    bare = core_ssd.ssd(x, a, bm, cm, 16)
    assert all(t.grad_fn is None for t in bare)
    with torch.no_grad():
        assert core_ssd.ssd(x.requires_grad_(), a, bm, cm, 16)[0].grad_fn \
            is None
    ops.reset_launch_counts()
    rec = core_ssd.ssd(x, a, bm, cm, 16)
    assert type(rec[0].grad_fn).__name__ == "_SSDBackward"
    assert all(torch.equal(u, v) for u, v in zip(rec, bare))
    assert ops.launch_counts()["ssd"] == 0          # the CPU runs no kernel


# -- the model, its gradients and the train step -------------------------------

def _cfgs(dt):
    return (dataclasses.replace(jax_get_config(ARCH, reduced=True), dtype=dt),
            dataclasses.replace(get_config(ARCH, reduced=True), dtype=dt))


def _close_bf16_logits(got, want):
    """bf16 logits at every position: within 2^-4 (atol and rtol) on all
    but 1 in 1,000 entries, and within 2^-3 on every entry."""
    got, want = got.detach().numpy(), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert (err > 2 ** -4 * (1 + np.abs(want))).mean() <= 1e-3, err.max()
    assert (err <= 2 ** -3 * (1 + np.abs(want))).all(), err.max()


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_trees(port_tree, jax_tree, **tol):
    want = _by_path(jax_tree)
    got = _by_path(jax.tree.map(lambda t: t.detach().float().numpy(),
                                port_tree))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


@pytest.fixture(scope="module")
def model():
    """f32 configs, the JAX params and AdamW state, three batches, and the
    JAX logits, loss and gradients on the first."""
    jcfg, cfg = _cfgs("float32")
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 2, 3), clip_norm=1.0)
    opt = adamw.AdamW(lr=adamw.cosine_schedule(1e-3, 2, 3), clip_norm=1.0)
    jstate = JTL.init_state(jcfg, jopt, jax.random.PRNGKey(0))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH, seed=0)
    batches = [data.batch_at(i) for i in range(3)]

    def reference(p, b):
        with POLICY.scope():
            logits, _ = JM.forward(jcfg, p, b)
            return logits, jax.value_and_grad(
                lambda q: JM.loss_fn(jcfg, q, b), has_aux=True)(p)

    ref = jax.jit(reference)(jstate.params,
                             jax.tree.map(jnp.asarray, batches[0]))
    return dict(jcfg=jcfg, cfg=cfg, jopt=jopt, opt=opt, jstate=jstate,
                batches=batches, ref=ref)


def test_config_takes_remat_full_and_refuses_dots():
    cfg = get_config(ARCH)
    assert cfg.remat == jax_get_config(ARCH).remat == "full"
    assert dataclasses.replace(cfg, remat="none").remat == "none"
    with pytest.raises(ValueError, match="'dots' is not ported"):
        dataclasses.replace(cfg, remat="dots")
    with pytest.raises(ValueError, match="'some' is unknown"):
        dataclasses.replace(cfg, remat="some")


def test_forward_and_loss_match_jax_f32(model):
    jlogits, ((jloss, jmet), _) = model["ref"]
    params = _bridge(model["jstate"].params)
    batch = _torch_batch(model["batches"][0])
    logits = M.forward(model["cfg"], params, batch)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **MODEL_TOL)
    loss, met = M.loss_fn(model["cfg"], params, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(met["tokens"]) == int(jmet["tokens"]) == BATCH * (SEQ - 1)
    assert set(met) == set(jmet)


def test_forward_and_loss_match_jax_bf16(model):
    """bf16 activations on the same f32 params (the JAX forward jitted
    once more, forward only)."""
    jcfg, cfg = _cfgs("bfloat16")
    batch = model["batches"][1]
    with POLICY.scope():
        jlogits, _ = jax.jit(lambda p, b: JM.forward(jcfg, p, b))(
            model["jstate"].params, jax.tree.map(jnp.asarray, batch))
        jloss, _ = jax.jit(lambda p, b: JM.loss_fn(jcfg, p, b))(
            model["jstate"].params, jax.tree.map(jnp.asarray, batch))
    params = _bridge(model["jstate"].params)
    logits = M.forward(cfg, params, _torch_batch(batch))
    assert logits.dtype == torch.float32
    _close_bf16_logits(logits, jlogits)
    loss, _ = M.loss_fn(cfg, params, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss),
                               rtol=LOSS_RTOL["bfloat16"])


def test_gradients_match_jax_leaf_for_leaf(model):
    _, (_, jgrads) = model["ref"]
    _, _, grads = TL._loss_and_grads(model["cfg"],
                                     _bridge(model["jstate"].params),
                                     _torch_batch(model["batches"][0]))
    _close_trees(grads, jgrads, **MTOL)


def test_three_accumulated_train_steps_match_jax(model):
    """Three steps of two microbatches each: the loss, ce_loss and grad
    norm of each, and the params and AdamW state after them."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jstate = model["jstate"]
    state = TL.TrainState(_bridge(jstate.params), adamw_state_from_numpy(
        jax.tree.map(np.asarray, jstate.opt), "cpu"))
    jstep = jax.jit(JTL.make_train_step(jcfg, model["jopt"], accum=2,
                                        policy=POLICY))
    step = TL.make_train_step(cfg, model["opt"], accum=2)
    for i, batch in enumerate(model["batches"]):
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, met = step(state, _torch_batch(batch))
        for key in ("loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       rtol=1e-5, err_msg=f"step {i} {key}")
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    want = _by_path(jstate.params)
    got = _by_path(jax.tree.map(lambda t: t.numpy(), state.params))
    for key in want:
        err = np.abs(got[key] - want[key])
        assert err.max() <= 1e-3, (key, err.max())
        assert (err > 2e-6).mean() <= 1e-3, (key, int((err > 2e-6).sum()))
    _close_trees(state.opt.m, jstate.opt.m, **MTOL)
    _close_trees(state.opt.v, jstate.opt.v, atol=1e-7, rtol=1e-4)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_remat_full_gives_the_bits_of_none(model, dt, monkeypatch):
    """cfg.remat "full" (the default) checkpoints each of the stack's
    layers and gives the loss and every gradient of "none" bit for bit;
    its recompute runs each layer's forward again."""
    cfg = dataclasses.replace(model["cfg"], dtype=dt)
    params = _bridge(model["jstate"].params)
    batch = _torch_batch(model["batches"][2])
    calls = []
    checkpoint = T.checkpoint

    def counted(*args, **kw):
        calls.append(1)
        return checkpoint(*args, **kw)

    monkeypatch.setattr(T, "checkpoint", counted)
    out = {}
    for remat in ("full", "none"):
        loss, _, grads = TL._loss_and_grads(
            dataclasses.replace(cfg, remat=remat), params, batch)
        out[remat] = [loss] + leaves(grads)
        assert len(calls) == cfg.n_layers
    assert all(torch.equal(u, v) for u, v in zip(out["full"], out["none"]))


def test_serving_never_checkpoints(model, monkeypatch):
    """A prefill, a decode step, and a forward under no_grad on params
    that require a gradient do not go through torch.utils.checkpoint."""
    def refuse(*a, **kw):
        raise AssertionError("checkpoint called where autograd records nothing")

    monkeypatch.setattr(T, "checkpoint", refuse)
    cfg = model["cfg"]
    params = _bridge(model["jstate"].params)
    batch = _torch_batch(model["batches"][0])
    cache = M.init_cache(cfg, BATCH, SEQ + 1, "cpu")
    M.prefill(cfg, params, batch, cache)
    M.decode_step(cfg, params, batch["tokens"][:, :1], SEQ, cache)
    with torch.no_grad():
        M.forward(cfg, tree_map(lambda t: t.requires_grad_(), params), batch)
