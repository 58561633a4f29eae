"""Training the port's moe family, mixtral-8x22b (8 experts top-2, a
sliding window) and arctic-480b (128 experts top-2 and a parallel dense
branch), at their reduced sizes (2 layers, 4 experts, groups of 32) on
the CPU against the JAX package, on the same numpy inputs and the same
weights (the JAX ones, bridged leaf for leaf): the loss with the
router's load-balance and z losses added, its metrics (the aux terms
and the dropped fraction), and every gradient leaf (the router's through
the renormalised top-k probabilities and both aux losses, the expert
banks' through the bank Functions' batched GEMMs), in both dispatch
modes, drop-free (a capacity factor of 4: every assignment kept) and
with drops where the capacity binds; rematerialisation of the blocks
(the router's sort and capacity cumsum recomputed), which must give the
bits of a step without it, the aux terms included; and three donated
AdamW steps of two microbatches each.

The JAX side runs jitted under `Policy()`, passed to each call. The
batches are 2 x 48 tokens: 3 groups of 32.

Stated tolerances: the loss and the aux terms rtol 1e-5 (the dropped
fraction exactly: the same routing); the gradients atol 1e-4, rtol 1e-5;
a step's loss and grad norm rtol 1e-5; the params after the steps atol
2e-6 on all but 1 in 1,000 entries of a leaf and 1e-3 on every entry;
the moments atol 1e-4 / 1e-7, rtol 1e-5 / 1e-4.
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
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.training import train_loop as TL

ARCHS = ("mixtral-8x22b", "arctic-480b")
POLICY = Policy()
SEQ, BATCH = 48, 2
MTOL = dict(atol=1e-4, rtol=1e-5)
AUX = ("moe_lb_loss", "moe_z_loss", "moe_dropped_frac")


def _cfgs(arch, dispatch="einsum", drops=True, dt="float32"):
    out = []
    for c in (jax_get_config(arch, reduced=True),
              get_config(arch, reduced=True)):
        moe = dataclasses.replace(c.moe, dispatch=dispatch)
        if not drops:
            moe = dataclasses.replace(moe, capacity_factor=4.0)
        out.append(dataclasses.replace(c, dtype=dt, moe=moe))
    return tuple(out)


def _batches(cfg, n):
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH, seed=0)
    return [data.batch_at(i) for i in range(n)]


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


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """The arch's f32 JAX params (one draw for every dispatch and
    capacity: neither changes the tree) and three batches."""
    jcfg, cfg = _cfgs(request.param)
    params = jax.jit(lambda k: JM.init_params(jcfg, k))(
        jax.random.PRNGKey(0))
    return dict(arch=request.param, params=params, batches=_batches(cfg, 3))


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("drops", [False, True], ids=["drop-free", "drops"])
def test_loss_aux_and_gradients_match_jax(model, dispatch, drops):
    """The loss (cross entropy plus both router losses), every aux term,
    and every leaf's gradient, the router's and the expert banks' (and
    Arctic's dense branch's) among them."""
    jcfg, cfg = _cfgs(model["arch"], dispatch, drops)
    batch = model["batches"][0]
    with POLICY.scope():
        (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
            lambda q, b: JM.loss_fn(jcfg, q, b), has_aux=True))(
            model["params"], jax.tree.map(jnp.asarray, batch))
    loss, met, grads = TL._loss_and_grads(cfg, _bridge(model["params"]),
                                          _torch_batch(batch))
    assert set(met) == set(jmet) == {"ce_loss", "tokens", "loss", *AUX}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for name in ("ce_loss", "moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                   rtol=1e-5, err_msg=name)
    assert float(met["moe_dropped_frac"]) == pytest.approx(
        float(jmet["moe_dropped_frac"]), abs=1e-6)
    assert (float(met["moe_dropped_frac"]) > 0) == drops
    np.testing.assert_allclose(
        float(loss), float(met["ce_loss"] + met["moe_lb_loss"]
                           + met["moe_z_loss"]), rtol=1e-6)
    _close_trees(grads, jgrads, **MTOL)
    for name in ("router", "w_gate", "w_up", "w_down"):
        g = grads["layers"]["moe"][name]
        g = g["w"] if isinstance(g, dict) else g
        assert g.abs().max() > 0, name


def test_router_losses_alone_reach_the_router(model):
    """With the cross entropy's gradient cut (every label -1), the loss is
    the router losses alone, and the router still gets their gradient,
    as jax.grad gives it."""
    jcfg, cfg = _cfgs(model["arch"])
    batch = dict(model["batches"][1])
    batch["labels"] = np.full_like(batch["labels"], -1)
    with POLICY.scope():
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda q, b: JM.loss_fn(jcfg, q, b), has_aux=True))(
            model["params"], jax.tree.map(jnp.asarray, batch))
    loss, met, grads = TL._loss_and_grads(cfg, _bridge(model["params"]),
                                          _torch_batch(batch))
    assert float(met["ce_loss"]) == 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert grads["layers"]["moe"]["router"]["w"].abs().max() > 0
    assert grads["lm_head"]["w"].abs().max() == 0
    _close_trees(grads, jgrads, **MTOL)


def test_three_donated_accumulated_train_steps_match_jax(model):
    """Three donated steps of two microbatches each (each microbatch of 48
    tokens routes in groups of its own, as the reference's microbatches
    do): the loss, ce_loss, aux terms and grad norm of each, and the
    params and AdamW state after them, in the tensors the port's state
    started in."""
    jcfg, cfg = _cfgs(model["arch"])
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 2, 3), clip_norm=1.0)
    opt = adamw.AdamW(lr=adamw.cosine_schedule(1e-3, 2, 3), clip_norm=1.0)
    jstate = JTL.TrainState(model["params"], jopt.init(model["params"]),
                            None)
    state = TL.TrainState(_bridge(jstate.params), adamw_state_from_numpy(
        jax.tree.map(np.asarray, jstate.opt), "cpu"))
    storage = [t.data_ptr() for t in leaves(state.params)
               + leaves(state.opt.m) + leaves(state.opt.v)]
    jstep = jax.jit(JTL.make_train_step(jcfg, jopt, accum=2, policy=POLICY))
    step = TL.make_train_step(cfg, opt, accum=2, donate=True)
    for i, batch in enumerate(model["batches"]):
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, met = step(state, _torch_batch(batch))
        for key in ("loss", "ce_loss", "grad_norm", "moe_lb_loss",
                    "moe_z_loss"):
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
    """cfg.remat "full" checkpoints each block, router and experts
    included, and gives the loss, the aux terms and every gradient of
    "none" bit for bit: the recompute's sort and capacity positions are
    the forward's, and its aux terms are not added again."""
    _, cfg = _cfgs(model["arch"], dt=dt)
    params = _bridge(model["params"])
    batch = _torch_batch(model["batches"][2])
    calls = []
    checkpoint = T.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return checkpoint(fn, *args, **kw)

    monkeypatch.setattr(T, "checkpoint", counted)
    out = {}
    for remat in ("full", "none"):
        loss, met, grads = TL._loss_and_grads(
            dataclasses.replace(cfg, remat=remat), params, batch)
        out[remat] = [loss] + [met[k] for k in AUX] + leaves(grads)
        assert calls == ["body"] * cfg.n_layers
    assert float(out["full"][3]) > 0, "expected dropped assignments"
    assert all(torch.equal(u, v) for u, v in zip(out["full"], out["none"]))
