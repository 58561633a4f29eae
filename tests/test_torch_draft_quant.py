"""The int8 path beyond the serving forward, against the JAX package: a
speculative draft with int8 weights (`ServingEngine(draft_quant="int8")`,
the JAX engine's `draft_policy` with quant="int8") and the gradient of
`core.gemm.dense_q` (`_DenseQ`, the JAX package's `_dense_q_vjp`).

The draft runs the reduced qwen3 in f32 on the JAX package's weights,
bridged into the port, the JAX engine under
`Policy(backend="pallas", interpret=True)`; the gradients are taken in
f32 against `jax.grad` at the tolerance of `tests/test_quant.py`'s VJP
test, 1e-4 x max(|ref|, 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gemm as jgemm
from repro.core.policy import Policy
from repro.serving import ServingEngine as JaxEngine
from repro_torch.core import gemm, precision
from repro_torch.kernels import ops
from repro_torch.serving import ServingEngine
from test_torch_spec import GENS, KW, PALLAS, _serve, model

# ----------------------------------------------------------------------
# the int8 draft
# ----------------------------------------------------------------------


@pytest.mark.parametrize("which", ["self", "seed1"])
def test_int8_draft_as_the_jax_engine(model, which, monkeypatch):
    """The draft's weights quantized once: every stream is the plain
    engine's (the target verifies), the streams, rounds and acceptance
    counts are the JAX engine's under `draft_policy` quant="int8", the
    draft's steps run the int8-weight GEMM, and its KV cache stays
    dense and in the compute dtype."""
    m = model
    cfg, jcfg = m["cfg"], m["jcfg"]
    draft = (cfg, m["params"] if which == "self" else m["draft"])
    jdraft = (jcfg, m["jparams"] if which == "self" else m["jdraft"])
    base, _ = _serve(ServingEngine(cfg, m["params"], device="cpu", **KW),
                     m["prompts"])
    eng = ServingEngine(cfg, m["params"], device="cpu", draft=draft,
                        spec_k=4, draft_quant="int8", **KW)
    spec = eng.spec
    assert "w_q" in spec.params["layers"]["attn"]["wq"]
    assert spec.params["layers"]["attn"]["wq"]["w_q"].dtype == torch.int8
    assert "w" in eng.params["layers"]["attn"]["wq"]     # the target's stay
    assert spec.cache["k"].dtype == torch.float32 and "pages" not in spec.cache
    calls = []
    matmul_q = ops.matmul_q

    def counted(*a, **kw):
        calls.append(a[1].shape)
        return matmul_q(*a, **kw)
    monkeypatch.setattr(ops, "matmul_q", counted)
    reqs, rep = _serve(eng, m["prompts"])
    monkeypatch.undo()
    # 7 int8 GEMMs a layer (Q, K, V, O, gate, up, down) a draft step or
    # prefill: k + 1 steps a round, one prefill an admission, one step a
    # remainder token; the target runs none
    L = cfg.n_layers
    rem = sum(len(p) % 8 for p in m["prompts"])
    assert len(calls) == 7 * L * (5 * rep["spec_rounds"] + len(reqs) + rem)
    jreqs, jrep = _serve(JaxEngine(jcfg, m["jparams"], policy=PALLAS,
                                   draft=jdraft, spec_k=4,
                                   draft_policy=PALLAS.replace(quant="int8"),
                                   **KW), m["prompts"])
    assert [r.generated for r in reqs] == [r.generated for r in base]
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    for key in ("spec_rounds", "spec_proposed", "spec_accepted",
                "n_finished", "decode_tokens"):
        assert rep[key] == jrep[key], key
    assert [(r.draft_proposed, r.draft_accepted) for r in reqs] == \
        [(r.draft_proposed, r.draft_accepted) for r in jreqs]
    assert [len(r.generated) for r in reqs] == GENS


def test_draft_quant_is_checked(model):
    cfg, params = model["cfg"], model["params"]
    with pytest.raises(ValueError, match="draft_quant"):
        ServingEngine(cfg, params, device="cpu", draft=(cfg, params),
                      draft_quant="int4", **KW)


# ----------------------------------------------------------------------
# the gradient of dense_q
# ----------------------------------------------------------------------

@pytest.mark.parametrize("activation", [None, "silu", "gelu"])
@pytest.mark.parametrize("bias,residual", [(True, True), (False, False)],
                         ids=["b-residual", "plain"])
def test_dense_q_gradient_equals_jax_grad(activation, bias, residual,
                                          monkeypatch):
    """d x, d scale, d b and d residual of act((x @ wq) * scale + b) + r
    against `jax.grad` of the JAX package's `dense_q`, in f32, within
    1e-4 x max(|ref|, 1); the call went through `_DenseQ`, and the int8
    weight takes no gradient."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 6, 48)).astype(np.float32)
    w = rng.normal(size=(48, 40)).astype(np.float32) * 0.2
    wq, scale = (t.numpy() for t in precision.quantize_int8(
        torch.from_numpy(w)))
    b = rng.normal(size=(40,)).astype(np.float32) if bias else None
    r = rng.normal(size=(3, 6, 40)).astype(np.float32) if residual else None
    cot = rng.normal(size=(3, 6, 40)).astype(np.float32)
    names = ["x", "scale"] + ["b"] * bias + ["residual"] * residual
    args = [x, scale] + [a for a in (b, r) if a is not None]

    def jloss(*ops_):
        kw = dict(zip(names, ops_))
        y = jgemm.dense_q(kw["x"], jnp.asarray(wq), kw["scale"], kw.get("b"),
                          activation=activation, residual=kw.get("residual"),
                          policy=Policy())
        return jnp.sum(y * cot)

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(
        *(jnp.asarray(a) for a in args))
    taken = []
    backward = gemm._DenseQ.backward

    def recorded(ctx, g):
        taken.append(g.shape)
        return backward(ctx, g)
    monkeypatch.setattr(gemm._DenseQ, "backward", staticmethod(recorded))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    kw = dict(zip(names, leaves))
    twq = torch.from_numpy(wq)
    y = gemm.dense_q(kw["x"], twq, kw["scale"], kw.get("b"),
                     activation=activation, residual=kw.get("residual"))
    (y * torch.from_numpy(cot)).sum().backward()
    assert taken == [(18, 40)]
    assert twq.grad is None and not twq.requires_grad
    for name, t, j in zip(names, leaves, want):
        j = np.asarray(j)
        np.testing.assert_allclose(
            t.grad.numpy(), j, rtol=0,
            atol=1e-4 * max(float(np.abs(j).max()), 1.0), err_msg=name)


def test_dense_q_gradient_of_scale_alone_and_off_the_tape():
    """Only the scale recorded: d scale alone, no d x; under no_grad the
    call records nothing."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    wq, scale = precision.quantize_int8(torch.from_numpy(
        rng.normal(size=(16, 8)).astype(np.float32)))
    s = scale.clone().requires_grad_()
    gemm.dense_q(x, wq, s, activation="gelu").sum().backward()
    want = scale.clone().requires_grad_()
    torch.nn.functional.gelu(x @ (wq.float() * want), approximate="tanh") \
        .sum().backward()
    torch.testing.assert_close(s.grad, want.grad, rtol=1e-5, atol=1e-5)
    assert x.grad is None
    with torch.no_grad():
        y = gemm.dense_q(x, wq, scale.clone().requires_grad_())
    assert y.grad_fn is None
