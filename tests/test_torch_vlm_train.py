"""Training the port's qwen2-vl-2b (the vlm family, reduced: 2 layers,
d 64, 4 query heads over 1 KV head, QKV biases, M-RoPE sections
(2, 3, 3)) on the CPU against the JAX package, on the same numpy inputs
and the same weights (the JAX ones, with the QKV biases drawn from a seed
in place of the zeros they start from, bridged leaf for leaf): batches
of SyntheticLM text with one 4 x 4 image span a row
(`data.pipeline.with_image`: patch embeddings added to the token
embeddings, (t, h, w) M-RoPE positions, labels -1 at the patches); the
loss and every gradient leaf, rematerialisation (which must give the
bits of a step without it), and three donated AdamW steps of two
microbatches each, the patch embeddings and positions cut along the
batch with the tokens.

The JAX side runs jitted under `Policy()`, passed to each call.

Stated tolerances, as `test_torch_hybrid_train.py`'s: the loss rtol
1e-5; the gradients atol 1e-4, rtol 1e-5; a step's loss and grad norm
rtol 1e-5; the params after the steps atol 2e-6 on all but 1 in 1,000
entries of a leaf (but K's bias, `NOISE_LEAF`) and 1e-3 on every entry;
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
from repro_torch.data.pipeline import with_image
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.training import train_loop as TL

ARCH = "qwen2-vl-2b"
POLICY = Policy()
SEQ, BATCH, AT, GRID = 28, 2, 6, (4, 4)
MTOL = dict(atol=1e-4, rtol=1e-5)
# K's bias shifts every score of a query's row alike, which the softmax
# cancels: its gradient is zero in exact arithmetic and rounding noise on
# either side, which Adam scales up to steps of ~lr. After the steps it is
# held to the 1e-3 bound alone.
NOISE_LEAF = "['layers']['attn']['wk']['b']"


def _cfgs(dt="float32"):
    return tuple(dataclasses.replace(c, dtype=dt) for c in (
        jax_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)))


def _jax_params(jcfg):
    """The JAX init with each QKV bias drawn from a seed (at init they are
    zeros, and their gradient path would add nothing)."""
    p = jax.jit(lambda k: JM.init_params(jcfg, k))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    attn = p["layers"]["attn"]
    for name in ("wq", "wk", "wv"):
        b = attn[name]["b"]
        attn[name]["b"] = jnp.asarray(rng.normal(size=b.shape) * 0.1, b.dtype)
    return p


def _batches(cfg, n):
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH, seed=0)
    return [with_image(data.batch_at(i), np.random.default_rng(100 + i),
                       cfg.d_model, at=AT, grid=GRID, scale=0.5)
            for i in range(n)]


def _bridge(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


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
    """f32 configs, the JAX train state, three batches, and the JAX loss,
    metrics and gradients on the first."""
    jcfg, cfg = _cfgs()
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 2, 3), clip_norm=1.0)
    opt = adamw.AdamW(lr=adamw.cosine_schedule(1e-3, 2, 3), clip_norm=1.0)
    params = _jax_params(jcfg)
    jstate = JTL.TrainState(params, jopt.init(params), None)
    batches = _batches(cfg, 3)

    def reference(p, b):
        with POLICY.scope():
            return jax.value_and_grad(
                lambda q: JM.loss_fn(jcfg, q, b), has_aux=True)(p)

    ref = jax.jit(reference)(params, jax.tree.map(jnp.asarray, batches[0]))
    return dict(jcfg=jcfg, cfg=cfg, jopt=jopt, opt=opt, jstate=jstate,
                batches=batches, ref=ref)


def test_image_batches_place_patches_and_positions():
    """A row's image span: patch embeddings only there, labels -1 there,
    and Qwen2-VL's positions: text at t = h = w, the patches at (AT,
    AT + r, AT + c), the text after from AT + max(grid)."""
    _, cfg = _cfgs()
    b = _batches(cfg, 1)[0]
    n = GRID[0] * GRID[1]
    assert (b["labels"][:, AT:AT + n] == -1).all()
    assert (b["labels"][:, :AT] >= 0).all()
    assert np.abs(b["patch_embeds"][:, AT:AT + n]).min() > 0
    assert not b["patch_embeds"][:, :AT].any()
    assert not b["patch_embeds"][:, AT + n:].any()
    pos = b["positions"][0]
    assert pos[AT - 1].tolist() == [AT - 1] * 3
    assert pos[AT + GRID[1] + 2].tolist() == [AT, AT + 1, AT + 2]
    assert pos[AT + n].tolist() == [AT + max(GRID)] * 3


def test_loss_and_gradients_match_jax_leaf_for_leaf(model):
    """The loss and every leaf's gradient on a batch with patch embeddings
    and M-RoPE positions: the QKV biases' among them, and the tied
    embedding's, which the patches' labels of -1 leave out."""
    (jloss, jmet), jgrads = model["ref"]
    loss, met, grads = TL._loss_and_grads(model["cfg"],
                                          _bridge(model["jstate"].params),
                                          _torch_batch(model["batches"][0]))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(met) == set(jmet)
    n_img = GRID[0] * GRID[1]
    assert int(met["tokens"]) == int(jmet["tokens"]) \
        == BATCH * (SEQ - 1 - n_img)
    _close_trees(grads, jgrads, **MTOL)
    for name in ("wq", "wv"):
        assert grads["layers"]["attn"][name]["b"].abs().max() > 1e-3, name


def test_positions_and_patches_reach_the_gradients(model):
    """The same batch with its patch embeddings zeroed, and with text
    positions in place of the image's, gives other gradients: both
    inputs are on the differentiated path (and the JAX package agrees on
    each)."""
    jcfg, cfg = model["jcfg"], model["cfg"]
    params = _bridge(model["jstate"].params)
    base = model["batches"][0]
    _, _, g0 = TL._loss_and_grads(cfg, params, _torch_batch(base))
    for what, batch in (
            ("patches", dict(base, patch_embeds=np.zeros_like(
                base["patch_embeds"]))),
            ("positions", dict(base, positions=np.ascontiguousarray(
                np.broadcast_to(np.arange(SEQ, dtype=np.int32)[None, :, None],
                                (BATCH, SEQ, 3)))))):
        _, _, g = TL._loss_and_grads(cfg, params, _torch_batch(batch))
        assert not torch.equal(g["layers"]["attn"]["wq"]["w"],
                               g0["layers"]["attn"]["wq"]["w"]), what
        with POLICY.scope():
            _, jg = jax.jit(jax.value_and_grad(
                lambda q, b: JM.loss_fn(jcfg, q, b), has_aux=True))(
                model["jstate"].params, jax.tree.map(jnp.asarray, batch))
        _close_trees(g, jg, **MTOL)


def test_three_donated_accumulated_train_steps_match_jax(model):
    """Three donated steps of two microbatches each: the loss, ce_loss and
    grad norm of each, and the params and AdamW state after them, in the
    tensors the port's state started in."""
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
        if key != NOISE_LEAF:
            assert (err > 2e-6).mean() <= 1e-3, (key, int((err > 2e-6).sum()))
    _close_trees(state.opt.m, jstate.opt.m, **MTOL)
    _close_trees(state.opt.v, jstate.opt.v, atol=1e-7, rtol=1e-4)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_remat_full_gives_the_bits_of_none(model, dt, monkeypatch):
    """cfg.remat "full" checkpoints each block and gives the loss and every
    gradient of "none" bit for bit."""
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
        assert calls == ["body"] * cfg.n_layers
    assert all(torch.equal(u, v) for u, v in zip(out["full"], out["none"]))
