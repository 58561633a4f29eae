"""Training the port's zamba2 (the hybrid family, reduced, at 4 layers:
two segments of 2 Mamba-2 layers, so the shared block runs twice and
each segment has its LoRA pair) on the CPU against the JAX package, on
the same numpy inputs and the same weights and optimizer state (the JAX
ones, with a seeded random lora_b in place of the zeros it starts from,
bridged leaf for leaf): logits and loss (f32 and bf16), the gradients
leaf for leaf (the shared block's summed over both segments, lora_a's
not zero), three donated AdamW steps of two microbatches each, and
rematerialisation of the Mamba layers (not the shared block), which must
give the bits of a step without it.

The JAX side runs jitted under `Policy()`, passed to each call. The
batches are 24 tokens long: the SSD chunk of 16 pads its second chunk.

Stated tolerances, as `test_torch_ssm_train.py`'s: logits f32 atol =
rtol = 1e-4; bf16 logits at every position 2^-4 (atol and rtol) on all
but 1 in 1,000 entries and 2^-3 on every entry; the loss rtol 1e-5 (f32), 2^-7 (bf16); the
gradients atol 1e-4, rtol 1e-5; a step's loss and grad norm rtol 1e-5;
the params after the steps atol 2e-6 on all but 1 in 1,000 entries of a
leaf and 1e-3 on every entry; the moments atol 1e-4 / 1e-7, rtol 1e-5 /
1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.policy import Policy
from repro.data.pipeline import SyntheticLM
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.training import train_loop as JTL
from repro_torch.bridge import adamw_state_from_numpy, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.tree import leaves
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.training import train_loop as TL

ARCH = "zamba2-1.2b"
N_LAYERS = 4                     # two segments of attn_every = 2
POLICY = Policy()
SEQ, BATCH = 24, 2
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
MTOL = dict(atol=1e-4, rtol=1e-5)


def _cfgs(dt):
    return (dataclasses.replace(jax_get_config(ARCH, reduced=True),
                                n_layers=N_LAYERS, dtype=dt),
            dataclasses.replace(get_config(ARCH, reduced=True),
                                n_layers=N_LAYERS, dtype=dt))


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
    """f32 configs, the JAX train state (lora_b drawn from a seed: at init
    it is zeros, and lora_a's gradient with it), three batches, and the
    JAX logits, loss and gradients on the first."""
    jcfg, cfg = _cfgs("float32")
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 2, 3), clip_norm=1.0)
    opt = adamw.AdamW(lr=adamw.cosine_schedule(1e-3, 2, 3), clip_norm=1.0)
    jstate = JTL.init_state(jcfg, jopt, jax.random.PRNGKey(0))
    lb = jstate.params["hybrid"]["lora_b"]
    jstate.params["hybrid"]["lora_b"] = jnp.asarray(
        np.random.default_rng(7).normal(size=lb.shape) * lb.shape[1] ** -0.5,
        lb.dtype)
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
    jcfg, cfg = _cfgs("bfloat16")
    batch = model["batches"][1]
    with POLICY.scope():
        jlogits, jloss = jax.jit(lambda p, b: (
            JM.forward(jcfg, p, b)[0], JM.loss_fn(jcfg, p, b)[0]))(
            model["jstate"].params, jax.tree.map(jnp.asarray, batch))
    params = _bridge(model["jstate"].params)
    logits = M.forward(cfg, params, _torch_batch(batch))
    _close_bf16_logits(logits, jlogits)
    loss, _ = M.loss_fn(cfg, params, _torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2 ** -7)


def test_gradients_match_jax_leaf_for_leaf(model):
    """Every leaf, the shared block's (used by both segments) and both
    LoRA pairs' among them; lora_a's gradient is not zero."""
    _, (_, jgrads) = model["ref"]
    _, _, grads = TL._loss_and_grads(model["cfg"],
                                     _bridge(model["jstate"].params),
                                     _torch_batch(model["batches"][0]))
    _close_trees(grads, jgrads, **MTOL)
    for s in range(N_LAYERS // model["cfg"].attn_every):
        assert grads["hybrid"]["lora_a"][s].abs().max() > 0


def test_three_donated_accumulated_train_steps_match_jax(model):
    """Three donated steps of two microbatches each, as the launcher takes
    them: the loss, ce_loss and grad norm of each, and the params and
    AdamW state after them, in the tensors the port's state started in."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    jstate = model["jstate"]
    state = TL.TrainState(_bridge(jstate.params), adamw_state_from_numpy(
        jax.tree.map(np.asarray, jstate.opt), "cpu"))
    storage = [t.data_ptr() for t in leaves(state.params)
               + leaves(state.opt.m) + leaves(state.opt.v)]
    jstep = jax.jit(JTL.make_train_step(jcfg, model["jopt"], accum=2,
                                        policy=POLICY))
    step = TL.make_train_step(cfg, model["opt"], accum=2, donate=True)
    for i, batch in enumerate(model["batches"]):
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, met = step(state, _torch_batch(batch))
        for key in ("loss", "ce_loss", "grad_norm"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                       rtol=1e-5, err_msg=f"step {i} {key}")
    assert storage == [t.data_ptr() for t in leaves(state.params)
                       + leaves(state.opt.m) + leaves(state.opt.v)]
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
    """cfg.remat "full" checkpoints each Mamba layer of each segment (the
    shared block, its in_proj and the LoRA stay outside) and gives the
    loss and every gradient of "none" bit for bit."""
    cfg = dataclasses.replace(model["cfg"], dtype=dt)
    params = _bridge(model["jstate"].params)
    batch = _torch_batch(model["batches"][2])
    calls = []
    checkpoint = T.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return checkpoint(fn, *args, **kw)

    monkeypatch.setattr(T, "checkpoint", counted)
    out = {}
    for remat in ("full", "none"):
        loss, _, grads = TL._loss_and_grads(
            dataclasses.replace(cfg, remat=remat), params, batch)
        out[remat] = [loss] + leaves(grads)
        assert calls == ["body"] * cfg.n_layers       # Mamba layer bodies
    assert all(torch.equal(u, v) for u, v in zip(out["full"], out["none"]))
