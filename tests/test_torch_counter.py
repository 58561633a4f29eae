"""The cost counter (`repro_torch.roofline.counter`) against the JAX
package's HLO analyzer (`repro.roofline.hlo.analyze`), and the kernel ops
under it.

Stated tolerances:
- FLOPs: exact. Both count 2·M·N·K a matrix product and nothing for
  elementwise work, on the same shapes: the 12-layer tanh(x @ w) stack,
  and the reduced qwen3-0.6b's forward and train step (f32, batch 2 x
  32, JAX under its default XLA policy, the route its roofline tests
  compile, whose attention is the chunked online softmax: every (query,
  key) pair, which the port's `flops` charge). One difference
  is named and held exactly: under remat "full" the port's step reruns
  each block's whole forward before its backward (torch.utils.checkpoint
  replays the function), where XLA drops the recomputed MLP, whose
  outputs nothing in the backward reads (the dual GEMM's backward
  recomputes gate and up itself, and the down projection's output feeds
  only the residual): the port counts L x (4 + 2)·M·d·d_ff more.
- The remat ratio of the tanh stack: within the reference's band
  (1.25, 1.45) in both packages.
- Bytes are counted differently by design: XLA charges each fusion its
  operands and outputs once, eager PyTorch each op, so the step's
  elementwise chains cost the port more and the compiled loop's carries
  cost the reference more. They are held within a factor of 2 of each
  other, and each op's charge exactly (its compulsory bytes).
- Each kernel op under a counter: its output bit for bit and the launch
  counts unchanged; one charge of exactly its FLOPs and bytes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.policy import Policy
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.roofline import hlo as H
from repro.training import train_loop as JTL
from repro_torch.bridge import adamw_state_from_numpy, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import precision
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels import ops, ref
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as an
from repro_torch.roofline import counter
from repro_torch.training import train_loop as TL


def _hlo(fn, *args):
    return H.analyze(jax.jit(fn).lower(*args).compile().as_text(), 1)


def _stack_inputs(layers=12):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((64, 128)).astype(np.float32),
            (rng.standard_normal((layers, 128, 128)) * 0.1).astype(np.float32))


def test_scan_stack_counts_every_layer():
    x, ws = _stack_inputs()
    want = 2 * 64 * 128 * 128 * 12
    jc = _hlo(lambda x, ws: jax.lax.scan(
        lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0], x, ws)
    h, w = torch.from_numpy(x), torch.from_numpy(ws)
    with counter.count() as c:
        for i in range(12):
            h = torch.tanh(h @ w[i])
    assert c.flops == want == jc.flops
    assert c.calls == {} and c.collective_summary() == {} \
        and c.ici_bytes == 0.0
    # each layer: x and w read, x @ w written (mm); that read, tanh written
    assert c.hbm_bytes == 12 * (64 * 128 + 128 * 128 + 3 * 64 * 128) * 4


def test_remat_recompute_visible_in_both():
    x, ws = _stack_inputs(8)

    def jloss(remat):
        body = (lambda c, w: (jnp.tanh(c @ w), None))
        body = jax.checkpoint(body) if remat else body
        return lambda x, ws: jnp.sum(jax.lax.scan(body, x, ws)[0] ** 2)
    jplain = _hlo(jax.grad(jloss(False), argnums=1), x, ws)
    jremat = _hlo(jax.grad(jloss(True), argnums=1), x, ws)

    def port(remat):
        h = torch.from_numpy(x)
        w = torch.from_numpy(ws).requires_grad_()
        layer = lambda c, wi: torch.tanh(c @ wi)   # noqa: E731
        with counter.count() as c:
            for i in range(8):
                h = torch.utils.checkpoint.checkpoint(
                    layer, h, w[i], use_reentrant=False) if remat \
                    else layer(h, w[i])
            (h ** 2).sum().backward()
        return c.flops
    ratio, jratio = port(True) / port(False), jremat.flops / jplain.flops
    assert 1.25 < ratio < 1.45, ratio
    assert 1.25 < jratio < 1.45, jratio
    # XLA's scanned backward takes every layer's input gradient, the
    # first one's too, which autograd skips: x needs none
    assert port(False) == jplain.flops - 2 * 64 * 128 * 128


@pytest.fixture(scope="module")
def qwen3():
    out = {}
    for remat in ("none", "full"):
        jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", reduced=True),
                                   dtype="float32", vocab=250, remat=remat)
        cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                                  dtype="float32", vocab=250, remat=remat)
        jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 2, 3),
                            clip_norm=1.0)
        opt = adamw.AdamW(lr=adamw.cosine_schedule(1e-3, 2, 3), clip_norm=1.0)
        jstate = JTL.init_state(jcfg, jopt, jax.random.PRNGKey(0))
        batch = JSyntheticLM(vocab=250, seq_len=32, batch=2,
                             seed=0).batch_at(0)
        jbatch = jax.tree.map(jnp.asarray, batch)
        with Policy().scope():
            jfwd = _hlo(lambda p, b: JM.forward(jcfg, p, b)[0],
                        jstate.params, jbatch)
            jstep = _hlo(JTL.make_train_step(jcfg, jopt, policy=Policy()),
                         jstate, jbatch)
        params = params_from_numpy(jax.tree.map(np.asarray, jstate.params),
                                   "cpu")
        tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
        with counter.count() as fwd:
            M.forward(cfg, params, tbatch)
        state = TL.TrainState(params, adamw_state_from_numpy(
            jax.tree.map(np.asarray, jstate.opt), "cpu"))
        with counter.count() as step:
            TL.make_train_step(cfg, opt)(state, tbatch)
        out[remat] = dict(cfg=cfg, jfwd=jfwd, jstep=jstep, fwd=fwd, step=step,
                          batch=tbatch)
    return out


@pytest.mark.parametrize("remat", ["none", "full"])
def test_reduced_qwen3_forward_and_train_step_match_the_hlo_count(qwen3,
                                                                  remat):
    r = qwen3[remat]
    cfg = r["cfg"]
    assert r["fwd"].flops == r["jfwd"].flops
    m, d, ff = 2 * 32, cfg.d_model, cfg.d_ff
    mlp_rerun = cfg.n_layers * 6 * m * d * ff if remat == "full" else 0
    assert r["step"].flops == r["jstep"].flops + mlp_rerun
    for got, want in ((r["fwd"], r["jfwd"]), (r["step"], r["jstep"])):
        assert 0.5 < got.hbm_bytes / want.hbm_bytes < 2.0
    # every layer's GEMMs, dual GEMM and attention pair, and the logits
    L = cfg.n_layers
    assert r["fwd"].calls == {"matmul": 5 * L + 1, "gated_matmul": L,
                              "flash_attention": L}
    assert sum(r["step"].tagged_bytes.values()) < r["step"].hbm_bytes
    assert r["step"].top_charges(3)[0][0] == \
        max(b for b, _, _ in r["step"].charges)


def test_a_fake_tensor_run_counts_what_a_real_one_does(qwen3):
    """Under a FakeTensorMode (shapes only: nothing is allocated, and the
    fake tensors' own `prim` metadata ops cost nothing) the reduced
    qwen3's forward counts exactly what the real run counts, and its
    train step the same FLOPs and charged calls; the step's bytes agree
    within 2%: autograd's backward of the loss zero-fills and copies one
    logits-sized gradient in the real run that the fake run does not."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    r = qwen3["none"]
    cfg, opt = r["cfg"], adamw.AdamW(lr=1e-3, clip_norm=1.0)

    def run():
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        with counter.count() as fwd:
            M.forward(cfg, params, r["batch"])
        with counter.count() as step:
            TL.make_train_step(cfg, opt)(
                TL.TrainState(params, opt.init(params)), r["batch"])
        return fwd, step
    (fwd, step) = run()
    with FakeTensorMode(allow_non_fake_inputs=True):
        (ffwd, fstep) = run()
    assert (ffwd.flops, ffwd.hbm_bytes, ffwd.calls) == \
        (fwd.flops, fwd.hbm_bytes, fwd.calls)
    assert (fstep.flops, fstep.calls) == (step.flops, step.calls)
    assert abs(fstep.hbm_bytes - step.hbm_bytes) <= 0.02 * step.hbm_bytes


def test_ops_matmul_is_charged_its_gemm_alone():
    m, k, n = 48, 96, 40
    a, b = torch.randn(m, k), torch.randn(k, n)
    with counter.count() as c:
        ops.matmul(a, b)
    assert c.flops == 2 * m * k * n
    assert c.hbm_bytes == (m * k + k * n + m * n) * 4
    assert c.calls == {"matmul": 1} and len(c.charges) == 1
    assert c.tagged_bytes == {"matmul": c.hbm_bytes}


def _rand(*shape, dtype=torch.float32, seed=[0]):
    seed[0] += 1
    g = torch.Generator().manual_seed(seed[0])
    return torch.randn(shape, generator=g).to(dtype)


def _op_cases():
    """(name, call, kernel, FLOPs, bytes) of each kernel op on small CPU
    tensors."""
    f32, bf16 = torch.float32, torch.bfloat16
    a, b, r = _rand(8, 32), _rand(32, 16), _rand(8, 16)
    wq, scale = precision.quantize_int8(_rand(32, 16))
    ab, wg, wu = _rand(8, 32, dtype=bf16), _rand(32, 16, dtype=bf16), \
        _rand(32, 16, dtype=bf16)
    e3, bank, gb, ub = _rand(3, 5, 32), _rand(3, 32, 16), _rand(3, 32, 16), \
        _rand(3, 32, 16)
    q, kc, vc = _rand(3, 1, 4, 16), _rand(3, 64, 2, 16), _rand(3, 64, 2, 16)
    pos = torch.tensor([-1, 5, 63], dtype=torch.int32)
    q3, nv = _rand(3, 3, 4, 16), torch.tensor([3, 2, 1], dtype=torch.int32)
    ps = 8
    kp, vp = _rand(24, ps, 2, 16), _rand(24, ps, 2, 16)
    table = torch.arange(24, dtype=torch.int32).reshape(3, 8)
    k8, ks = precision.quantize_kv(kp)
    v8, vs = precision.quantize_kv(vp)
    ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
    qa, ka, va = _rand(2, 24, 4, 16), _rand(2, 24, 2, 16), _rand(2, 24, 2, 16)
    o, lse = ref.flash_attention_fwd_ref(qa, ka, va, window=8)
    x, av = _rand(1, 32, 4, 8), -torch.rand(1, 32, 4) * 0.5
    bm, cm = _rand(1, 32, 1, 8), _rand(1, 32, 1, 8)
    s0 = _rand(1, 4, 8, 8)
    xc, yc = torch.complex(a, _rand(8, 32)), torch.complex(_rand(8, 32), a)
    # decode keys: slot 0 idle, slot 1 keys 0..5, slot 2 keys 0..63
    keys1 = 6 + 64
    # rows (n_valid 3, 2, 1 at pos -1, 5, 63): slot 1 rows at 5, 6 see
    # keys 0..5 and 0..6 (union 7 keys, 13 pairs); slot 2 row 63 sees 64
    keys3, pairs3 = 7 + 64, 6 + 7 + 64
    # pages of 8: slot 1 page 0; slot 2 pages 0..7
    return [
        ("matmul residual", lambda: ops.matmul(a, b, epilogue="residual",
                                               residual=r), "matmul",
         2 * 8 * 32 * 16, (8 * 32 + 32 * 16 + 2 * 8 * 16) * 4),
        ("matmul_q bias", lambda: ops.matmul_q(a, wq, scale, epilogue="bias",
                                               bias=r[0]), "matmul_q",
         2 * 8 * 32 * 16, 8 * 32 * 4 + 32 * 16 + 16 * 4 + 8 * 16 * 4 + 16 * 4),
        ("gated_matmul bf16", lambda: ops.gated_matmul(ab, wg, wu),
         "gated_matmul", 4 * 8 * 32 * 16, (8 * 32 + 2 * 32 * 16 + 8 * 16) * 2),
        ("matmul_batched", lambda: ops.matmul_batched(e3, bank),
         "matmul_batched", 2 * 3 * 5 * 32 * 16,
         (3 * 5 * 32 + 3 * 32 * 16 + 3 * 5 * 16) * 4),
        ("gated_matmul_batched", lambda: ops.gated_matmul_batched(e3, gb, ub),
         "gated_matmul_batched", 4 * 3 * 5 * 32 * 16,
         (3 * 5 * 32 + 2 * 3 * 32 * 16 + 3 * 5 * 16) * 4),
        ("flash_decode", lambda: ops.flash_decode(q, kc, vc, pos=pos),
         "flash_decode", 4 * keys1 * 4 * 16,
         (2 * q.numel() + 2 * keys1 * 2 * 16) * 4 + 3 * 4),
        ("flash_decode rows", lambda: ops.flash_decode(
            q3, kc, vc, pos=pos, n_valid=nv), "flash_decode_rows",
         4 * pairs3 * 4 * 16, (2 * q3.numel() + 2 * keys3 * 2 * 16) * 4 + 24),
        ("flash_decode_paged int8", lambda: ops.flash_decode_paged(
            q, k8, v8, table, pos=pos, ks=ks, vs=vs), "flash_decode_paged",
         4 * keys1 * 4 * 16,
         2 * q.numel() * 4 + 2 * keys1 * 2 * (16 + 4) + 9 * 4 + 3 * 4),
        ("flash_attention_fwd", lambda: ops.flash_attention_fwd(
            qa, ka, va, window=8), "flash_attention",
         4 * 2 * 4 * 24 * 24 * 16,
         (2 * qa.numel() + 2 * ka.numel()) * 4 + 2 * 4 * 24 * 4),
        ("flash_attention", lambda: ops.flash_attention(qa, ka, va,
                                                        causal=False),
         "flash_attention", 4 * 2 * 4 * 24 * 24 * 16,
         (2 * qa.numel() + 2 * ka.numel()) * 4),
        ("flash_attention_bwd", lambda: ops.flash_attention_bwd(
            qa, ka, va, o, qa, lse, window=8), "flash_attention_bwd",
         8 * 2 * 4 * 24 * 24 * 16,
         (4 * qa.numel() + 4 * ka.numel()) * 4 + lse.numel() * 4),
        ("ssd", lambda: ops.ssd(x, av, bm, cm, 16, init_state=s0), "ssd",
         an._ssd_flops(1, 32, 4, 8, 8, 16, False, True),
         (2 * x.numel() + av.numel() + 2 * bm.numel() + 2 * s0.numel()) * 4),
        ("matmul_naive", lambda: ops.matmul_naive(a, b), "matmul_naive",
         2 * 8 * 32 * 16, (8 * 32 + 32 * 16 + 8 * 16) * 4),
        ("add", lambda: ops.add(a, a), "binary_op", a.numel(),
         3 * a.numel() * 4),
        ("sub complex", lambda: ops.sub(xc, yc), "binary_op",
         2 * a.numel(), 3 * a.numel() * 8),
        ("axpy", lambda: ops.axpy(0.5, a, a), "axpy", 2 * a.numel(),
         3 * a.numel() * 4),
    ]


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_each_op_is_charged_once_and_changes_nothing(case):
    _, call, kernel, flops, nbytes = case
    ops.reset_launch_counts()
    want = call()
    launches = ops.launch_counts()
    with counter.count() as c:
        got = call()
    assert ops.launch_counts() == launches
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        assert torch.equal(g, w)
    assert c.calls == {kernel: 1} and len(c.charges) == 1
    assert (c.flops, c.hbm_bytes) == (flops, nbytes)


def test_kept_products_count_what_the_mask_keeps():
    """The kept FLOPs of a causal flash call are its unmasked pairs' (the
    backward 10 products a pair), of an SSD chunk its causal half, beside
    the reference's convention in `flops`; an aten product and decode
    count the same in both."""
    q, k = _rand(1, 10, 2, 8), _rand(1, 10, 2, 8)
    o, lse = ref.flash_attention_fwd_ref(q, k, k, window=4)
    pairs = an.attention_pairs(10, 10, True, 4)
    assert pairs == 1 + 2 + 3 + 7 * 4
    with counter.count() as c:
        ops.flash_attention_fwd(q, k, k, window=4)
        ops.flash_attention_bwd(q, k, k, o, q, lse, window=4)
    assert c.kept_flops == (4 + 10) * 2 * pairs * 8
    assert c.flops == (4 + 8) * 2 * 10 * 10 * 8
    assert [f for _, _, f in c.charges] == [4 * 2 * 100 * 8, 8 * 2 * 100 * 8]
    assert an.attention_pairs(3, 5, False, None) == 15
    assert an._ssd_flops(1, 8, 1, 2, 2, 4, True, False) == \
        2 * (2 * 10 * 2 + 2 * 10 * 2 + 2 * 4 * 2 * 2)
    pos = torch.tensor([3, 9], dtype=torch.int32)
    with counter.count() as c:
        _rand(4, 8) @ _rand(8, 3)
        ops.flash_decode(_rand(2, 1, 2, 8), k.expand(2, -1, -1, -1),
                         k.expand(2, -1, -1, -1), pos=pos)
    assert c.kept_flops == c.flops == 2 * 4 * 8 * 3 + 4 * (4 + 10) * 2 * 8


def test_count_refuses_nesting_and_unknown_conventions():
    with counter.count() as c:
        with pytest.raises(RuntimeError, match="already active"):
            with counter.count():
                pass
    assert counter.ACTIVE is None
    # no card: no peak is read
    assert c.peak_bytes is None
    # no convention to pick: a count holds both (flops, kept_flops)
    with pytest.raises(TypeError):
        counter.count(products="kept")


def test_the_peak_is_read_without_resetting_the_statistic(monkeypatch):
    """count() never resets the process's peak statistic: the run's peak
    is the statistic where the run raised it, or where the caller reset
    it just before (the statistic then began at the allocation), else
    unknown."""
    now = {"peak": 0}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a: now["peak"])
    for (entry_peak, entry_alloc), peak, want in (
            ((200, 100), 250, 250),        # the run raised the peak
            ((100, 100), 100, 100),        # reset just before
            ((200, 100), 200, None)):      # an older, higher peak
        now["peak"] = peak
        assert counter._window_peak(entry_peak, entry_alloc) == want


def _count_launches(monkeypatch):
    """The kernel wrappers of a dense step replaced by their plain
    versions, each adding one to its launch count, and the ops sent to
    them (as on the card)."""
    def counted(mod, name, fn):
        def wrapper(*a, **kw):
            mod.LAUNCHES[name if name != "flash_decode" or a[0].shape[1] == 1
                         else "flash_decode_rows"] += 1
            return fn(*a, **kw)
        return wrapper
    monkeypatch.setattr(ops, "_on_card", lambda t: True)
    monkeypatch.setattr(kmm, "matmul_tiled", counted(
        kmm, "matmul", lambda a, b, out_dtype, epilogue, epilogue_operand:
        ref.fused_matmul_ref(a, b, out_dtype, epilogue, bias=epilogue_operand,
                             residual=epilogue_operand)))
    monkeypatch.setattr(kmm, "gated_matmul_tiled", counted(
        kmm, "gated_matmul", ref.gated_matmul_ref))
    monkeypatch.setattr(kfa, "flash_attention", counted(
        kfa, "flash_attention", lambda q, k, v, causal, window,
        return_lse=False: (ref.flash_attention_fwd_ref(
            q, k, v, causal=causal, window=window)
            if return_lse else ref.flash_attention_fwd_ref(
                q, k, v, causal=causal, window=window)[0])))
    monkeypatch.setattr(kfa, "flash_attention_bwd", counted(
        kfa, "flash_attention_bwd", ref.flash_attention_bwd_ref))
    monkeypatch.setattr(kfa, "flash_decode", counted(
        kfa, "flash_decode", lambda q, k, v, pos, window, n_valid:
        ref.decode_rows_ref(q, k, v, pos=pos, window=window,
                            n_valid=n_valid)))


def test_charged_calls_are_the_steps_launches(monkeypatch, qwen3):
    """A decode step and a train step of the reduced qwen3 with the kernel
    wrappers counting their launches: each launch is charged exactly
    once."""
    _count_launches(monkeypatch)
    cfg = qwen3["full"]["cfg"]
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = M.init_cache(cfg, 3, 40, "cpu")
    tokens = torch.tensor([[5], [7], [9]])
    M.prefill(cfg, params, {"tokens": torch.randint(0, 250, (3, 16))}, cache)
    for fn in (lambda: M.decode_step(cfg, params, tokens, torch.tensor(
                   [16, 16, -1], dtype=torch.int32), cache),
               lambda: TL.make_train_step(cfg, adamw.AdamW(lr=1e-3))(
                   TL.TrainState(params, adamw.AdamW(lr=1e-3).init(params)),
                   qwen3["full"]["batch"])):
        before = ops.launch_counts()
        with counter.count() as c:
            fn()
        after = ops.launch_counts()
        launched = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        assert launched and c.calls == launched
