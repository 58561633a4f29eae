"""Training the port's whisper-tiny (the encdec family, reduced: 2
encoder and 2 decoder layers, d 64, 4 heads of 16, 32 encoder frames,
and a vocab of 250, so that the tied logits' 6 pad classes are masked
under autograd) on the CPU against the JAX package, on the same numpy
inputs and the same weights (the JAX ones, every bias and norm drawn
from a seed in place of the zeros and ones they start from, bridged leaf
for leaf): the loss and every gradient leaf (the encoder, the
cross-attention over its output, the layernorms and the gelu MLPs among
them), the layernorm's gradient alone, rematerialisation of both stacks
(which must give the bits of a step without it), and three donated
AdamW steps of two microbatches each.

The JAX side runs jitted under `Policy()`, passed to each call.

Stated tolerances, as `test_torch_hybrid_train.py`'s: the loss rtol
1e-5; the gradients atol 1e-4, rtol 1e-5; the layernorm's gradient of
x atol 1e-6, rtol 1e-5, of its scale and bias (f32 sums over 6,000
rows, of size ~100) atol 2e-4, rtol 1e-5; a step's loss and grad norm
rtol 1e-5; the params after the steps atol 2e-6 on all but 1 in 1,000
entries of a leaf and 1e-3 on every entry; the moments atol 1e-4 /
1e-7, rtol 1e-5 / 1e-4.
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
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.training import train_loop as JTL
from repro_torch.bridge import adamw_state_from_numpy, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.tree import leaves
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.training import train_loop as TL

ARCH = "whisper-tiny"
VOCAB = 250                      # padded to 256: 6 masked pad classes
POLICY = Policy()
SEQ, BATCH = 24, 2
MTOL = dict(atol=1e-4, rtol=1e-5)


def _cfgs(dt="float32"):
    return tuple(dataclasses.replace(c, dtype=dt, vocab=VOCAB) for c in (
        jax_get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)))


def _jax_params(jcfg):
    """The JAX init, each bias and norm scale then drawn from a seed (at
    init they are zeros and ones: a bias path that adds nothing, or a
    norm scale's gradient read as the shift's, would pass)."""
    p = jax.jit(lambda k: JM.init_params(jcfg, k))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)

    def draw(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = draw(v)
            elif k in ("b", "bias"):
                out[k] = jnp.asarray(rng.normal(size=v.shape) * 0.1, v.dtype)
            elif k == "scale":
                out[k] = jnp.asarray(1 + rng.normal(size=v.shape) * 0.1,
                                     v.dtype)
            else:
                out[k] = v
        return out
    return draw(p)


def _batches(cfg, n):
    """SyntheticLM token batches, each with (B, enc_ctx, d_model) f32
    frames drawn from a seed of its own."""
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH, seed=0)
    out = []
    for i in range(n):
        b = data.batch_at(i)
        b["enc_frames"] = np.random.default_rng(100 + i).standard_normal(
            (BATCH, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


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


def test_loss_and_gradients_match_jax_leaf_for_leaf(model):
    """The loss and its metrics, and every leaf's gradient: the encoder's
    blocks and final norm, the decoder's self- and cross-attention (the
    cross K/V projections' gradients come through the encoder's output),
    the layernorms, the gelu MLPs' weights and biases, and the tied
    embedding, whose pad rows get no gradient."""
    (jloss, jmet), jgrads = model["ref"]
    loss, met, grads = TL._loss_and_grads(model["cfg"],
                                          _bridge(model["jstate"].params),
                                          _torch_batch(model["batches"][0]))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(met) == set(jmet) == {"ce_loss", "tokens", "loss"}
    assert int(met["tokens"]) == int(jmet["tokens"]) == BATCH * (SEQ - 1)
    _close_trees(grads, jgrads, **MTOL)
    assert grads["embed"]["w"][VOCAB:].abs().max() == 0
    for name in ("enc_layers", "dec_layers"):
        assert grads[name]["mlp"]["w_in"]["b"].abs().max() > 0, name
    assert grads["dec_layers"]["cross_attn"]["wk"]["w"].abs().max() > 0


def test_layernorm_gradient_matches_jax():
    """layernorm_apply's gradients (x, scale, bias) against jax.grad of
    the reference's, at the encoder's 4 x 1500 rows of 384, f32."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 1500, 384)).astype(np.float32)
    p = {"scale": 1 + 0.1 * rng.standard_normal(384).astype(np.float32),
         "bias": 0.1 * rng.standard_normal(384).astype(np.float32)}
    g = rng.standard_normal(x.shape).astype(np.float32)

    jx, jvjp = jax.vjp(lambda p_, x_: JL.layernorm_apply(p_, x_),
                       jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    jp, jxg = jvjp(jnp.asarray(g))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y = L.layernorm_apply(tp, tx)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jx),
                               atol=1e-5, rtol=1e-5)
    dx, ds, db = torch.autograd.grad(y, (tx, tp["scale"], tp["bias"]),
                                     torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jxg), atol=1e-6,
                               rtol=1e-5)
    for got, want in ((ds, jp["scale"]), (db, jp["bias"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                                   rtol=1e-5)


def test_three_donated_accumulated_train_steps_match_jax(model):
    """Three donated steps of two microbatches each (the frames cut along
    the batch with the tokens): the loss, ce_loss and grad norm of each,
    and the params and AdamW state after them, in the tensors the port's
    state started in."""
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
    """cfg.remat "full" checkpoints each encoder block and each decoder
    block (whose cross-attention reads the encoder's output by closure)
    and gives the loss and every gradient of "none" bit for bit."""
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
        assert calls == ["body"] * (cfg.n_enc_layers + cfg.n_layers)
    assert all(torch.equal(u, v) for u, v in zip(out["full"], out["none"]))
    assert out["full"][0].isfinite()
