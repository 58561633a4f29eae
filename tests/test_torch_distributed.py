"""The port's distribution layer on one process, against the JAX package:
the sharding rules (every leaf of every arch at full size, from shapes
alone, with no mesh and on the 16x16 and 2x16x16 production meshes'
axis sizes), the cache rules at every shape cell, the communication
model, the logical constraints, int8 error-feedback compression bit for
bit, the dry-run's input stand-ins, and three compressed train steps
against the JAX compressed step. The multi-rank paths (gloo worlds) are
in test_torch_distributed_multi.py.

Stated tolerances: compression and its error buffers bit for bit (f32
arithmetic, both round half to even); the compressed train steps of the
reduced qwen3 in f32 on shared weights: the loss within 1e-4, the
params within 5e-3 (the reference test's bound; 2 * lr bounds one entry
whose quantised gradient takes the other sign under Adam).

Nothing here changes process-wide state: the launcher's world of 1 is
destroyed when it returns, and the JAX policy is passed to each step.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import SHAPES as JSHAPES
from repro.core import distributed as jdist
from repro.core import policy as jpolicy
from repro.core.policy import Policy
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.distributed import compression as jcomp
from repro.distributed import context as jctx
from repro.distributed import sharding as JSH
from repro.launch import specs as JS
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.training import train_loop as JTL
from repro_torch.bridge import adamw_state_from_numpy, params_from_numpy
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import SHAPES, get_shape
from repro_torch.core import distributed as D
from repro_torch.distributed import compression as comp
from repro_torch.distributed import context as ctx
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as S
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.training import train_loop as TL

PALLAS = Policy(backend="pallas", interpret=True)
SIZES = {"none": None, "16x16": {"data": 16, "model": 16},
         "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(autouse=True)
def _keep_warn_once_state():
    """The JAX attention warns once per process under an ambient pallas
    scope; put its warn-once set back as it was."""
    saved = set(jpolicy._warned)
    yield
    jpolicy._warned.clear()
    jpolicy._warned.update(saved)


def _jmesh(sizes):
    """What the reference's rules read of a mesh: `.shape[name]`."""
    return None if sizes is None else types.SimpleNamespace(shape=sizes)


def _tmesh(sizes):
    """What the port's context reads of a mesh: names and sizes."""
    return types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                 shape=tuple(sizes.values()))


_TREES = {}


def _trees(arch):
    """(the reference's param shapes by path, the port's), at full size
    from shapes alone (jax.eval_shape; a FakeTensorMode init)."""
    if arch not in _TREES:
        jp = jax.eval_shape(lambda: JM.init_params(jax_get_config(arch),
                                                   jax.random.PRNGKey(0)))
        want = {JSH._path_str(p): tuple(x.shape) for p, x in
                jax.tree_util.tree_flatten_with_path(jp)[0]}
        got = {}
        SH._map_paths(lambda ps, x: got.__setitem__(ps, tuple(x.shape)),
                      _fake_params(arch))
        _TREES[arch] = (want, got)
    return _TREES[arch]


def _fake_params(arch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return M.init_params(get_config(arch), torch.Generator(), "cpu")


# -- the sharding rules ---------------------------------------------------

@pytest.mark.parametrize("mesh", list(SIZES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_spec_for_equals_the_reference_on_every_leaf(arch, mesh):
    want, got = _trees(arch)
    assert got == want                        # the same paths and shapes
    sizes = SIZES[mesh]
    for path, shape in want.items():
        ref = JSH.spec_for(path, shape, _jmesh(sizes))
        port = SH.spec_for(path, shape, sizes)
        assert tuple(port) == tuple(ref), (path, shape, port, ref)


def test_param_spec_rules():
    """The reference's spot checks (`tests/test_distributed.py`)."""
    P = SH.P
    assert SH.spec_for("layers/attn/wq/w", (28, 1024, 2048)) == \
        P(None, "data", "model")
    assert SH.spec_for("layers/moe/w_gate", (56, 8, 6144, 16384)) == \
        P(None, "model", "data", None)
    assert SH.spec_for("embed/w", (151936, 1024)) == P("model", "data")
    assert SH.spec_for("final_norm/scale", (1024,)) == P(None)
    assert SH.spec_for("hybrid/mamba/mamba/in_proj/w",
                       (6, 6, 2048, 8448)) == P(None, None, "data", "model")


def test_divisibility_fallback_and_any_mesh():
    """Mixtral's 8 experts on a 16-wide "model" axis take the second
    candidate; a DeviceMesh-like object, a dict and None all work."""
    shape = (56, 8, 6144, 16384)
    want = JSH.spec_for("layers/moe/w_gate", shape, _jmesh(SIZES["16x16"]))
    for mesh in (SIZES["16x16"], _tmesh(SIZES["16x16"])):
        assert tuple(SH.spec_for("layers/moe/w_gate", shape, mesh)) \
            == tuple(want) == (None, None, "data", "model")
    # a 7-wide axis divides nothing: the last candidate, axes dropped
    odd = {"data": 7, "model": 7}
    assert tuple(SH.spec_for("layers/moe/w_gate", shape, odd)) == tuple(
        JSH.spec_for("layers/moe/w_gate", shape, _jmesh(odd)))


@pytest.mark.parametrize("cell", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_equal_the_reference(arch, cell):
    jc = JS.cache_specs_struct(jax_get_config(arch),
                               [s for s in JSHAPES if s.name == cell][0])
    tc = S.cache_specs_struct(get_config(arch), get_shape(cell))
    want_shapes = {JSH._path_str(p): tuple(x.shape) for p, x in
                   jax.tree_util.tree_flatten_with_path(jc)[0]}
    got_shapes = {}
    SH._map_paths(lambda ps, x: got_shapes.__setitem__(ps, tuple(x.shape)),
                  tc)
    assert got_shapes == want_shapes
    for multi_pod, sizes in ((False, SIZES["16x16"]),
                             (True, SIZES["2x16x16"])):
        want = JSH.cache_specs(jc, _jmesh(sizes), multi_pod=multi_pod)
        want = {JSH._path_str(p): tuple(s) for p, s in
                jax.tree_util.tree_flatten_with_path(
                    want, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))[0]}
        got = {}
        SH._map_paths(lambda ps, s: got.__setitem__(ps, tuple(s)),
                      SH.cache_specs(tc, sizes, multi_pod=multi_pod))
        assert got == want, (arch, cell, multi_pod)
    if cell == "long_500k":             # batch 1 never claims the data axis
        assert all("data" not in str(s) for s in got.values())


def test_model_layout_keeps_the_model_axis_alone():
    cfg = get_config("qwen3-0.6b")
    spec = SH.model_layout(cfg, _fake_params("qwen3-0.6b"), SIZES["16x16"])
    P = SH.P
    assert spec["layers"]["attn"]["wq"]["w"] == P(None, None, "model")
    assert spec["layers"]["attn"]["wo"]["w"] == P(None, "model", None)
    # 8 KV heads over 16: replicated, each rank reads the head of its
    # query heads (models.attention)
    assert spec["layers"]["attn"]["wk"]["w"] == P(None, None, None)
    assert spec["embed"]["w"] == P("model", None)
    assert spec["layers"]["mlp"]["w_down"]["w"] == P(None, "model", None)
    sharded = SH.model_sharded(cfg, _fake_params("qwen3-0.6b"), 16)
    assert sharded["layers"]["attn"]["wq"]["w"] \
        and not sharded["layers"]["attn"]["wk"]["w"] \
        and not sharded["final_norm"]["scale"]


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES
                                  if get_config(a).family != "dense"])
def test_other_families_refuse_a_model_axis(arch):
    """No tensor parallelism outside the dense family yet: the refusal
    names the ROADMAP item; a model axis of 1 passes."""
    cfg = get_config(arch, reduced=True)
    SH.check_tp(cfg, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        SH.check_tp(cfg, 2)
    with ctx.mesh_context(_tmesh({"data": 1, "model": 2})):
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
            M.forward(cfg, {}, {"tokens": torch.zeros(1, 4, dtype=torch.long)})


def test_heads_that_do_not_divide_refuse():
    with pytest.raises(ValueError, match="n_heads 40"):
        SH.check_tp(get_config("qwen1.5-32b"), 16)
    SH.check_tp(get_config("granite-20b"), 16)     # MQA: K/V replicated


# -- the communication model and the constraints ----------------------------

@pytest.mark.parametrize("schedule", ["column", "row", "ring"])
def test_comm_model_bytes_exact(schedule):
    for m, n, k, p, item in ((4096, 4096, 4096, 4, 2), (256, 64, 128, 8, 4),
                             (1000, 30, 77, 3, 4), (1, 1, 1, 1, 2)):
        assert D.comm_model_bytes(m, n, k, p, item, schedule) == \
            jdist.comm_model_bytes(m, n, k, p, item, schedule)
    with pytest.raises(ValueError):
        D.comm_model_bytes(1, 1, 1, 1, 1, "tree")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_constrain_maps_logical_axes_as_the_reference(monkeypatch,
                                                      multi_pod):
    seen = []
    monkeypatch.setattr(jctx, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(spec) or x)
    sizes = SIZES["2x16x16" if multi_pod else "16x16"]
    cases = [((32, 128, 40, 64), ("dp", None, "tp", None)),
             ((1, 524288, 8, 128), ("dp", "free", "tp", None)),
             ((48, 8, 16), ("tp", "dp", None)),
             ((16, 48), (None, "tp"))]
    x = torch.zeros(1)
    for shape, logical in cases:
        with jctx.mesh_context(_jmesh(sizes), multi_pod=multi_pod):
            jctx.constrain(jax.ShapeDtypeStruct(shape, jnp.float32),
                           *logical)
        ref = tuple(ctx.UNCONSTRAINED if p is jax.sharding.PartitionSpec
                    .UNCONSTRAINED else p for p in seen[-1])
        with ctx.mesh_context(_tmesh(sizes), multi_pod=multi_pod):
            assert ctx.logical_spec(shape, logical) == ref, (shape, logical)
            assert ctx.constrain(x, *logical) is x   # a plain tensor
    assert ctx.constrain(x, "dp") is x                # no mesh


# -- compression ------------------------------------------------------------

def _grads(rng):
    return {"a": {"w": rng.normal(size=(64, 48)).astype(np.float32)},
            "b": (rng.normal(size=(300,)) * 1e-3).astype(np.float32),
            "c": np.zeros((5, 7), np.float32),
            # exact halves of the scale: round half to even on both sides
            "t": np.array([127, 63.5, -0.5, 0.5, 1.5, 2.5, -2.5, 3.5],
                          np.float32)}


def test_quantize_and_error_feedback_bit_for_bit():
    rng = np.random.default_rng(0)
    params = _grads(rng)
    jef = jcomp.init_ef(jax.tree.map(jnp.asarray, params))
    ef = comp.init_ef(params_from_numpy(params, "cpu"))
    for step in range(4):
        g = _grads(rng)
        jg, jef = jcomp.compress_grads(jax.tree.map(jnp.asarray, g), jef)
        tg, ef = comp.compress_grads(params_from_numpy(g, "cpu"), ef)
        for want, got in ((jg, tg), (jef.error, ef.error)):
            for (p, w), x in zip(jax.tree_util.tree_flatten_with_path(
                    want)[0], jax.tree.leaves(jax.tree.map(
                        lambda t: t.numpy(), got))):
                assert np.array_equal(np.asarray(w), x), (step, p)
    x = rng.normal(size=(33, 17)).astype(np.float32)
    jq, js = jcomp.quantize(jnp.asarray(x))
    q, s = comp.quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and np.array_equal(np.asarray(jq), q.numpy())
    assert np.float32(js) == np.float32(s.item())
    assert np.array_equal(np.asarray(jcomp.dequantize(jq, js)),
                          comp.dequantize(q, s).numpy())


def test_compression_ratio_exact():
    p = {"w": np.zeros((1024, 3072), np.float32),
         "b": np.zeros((7,), np.float32),
         "h": {"x": np.zeros((3, 5), np.float32)}}
    for bits in (8, 4):
        assert comp.compression_ratio(params_from_numpy(p, "cpu"), bits) \
            == jcomp.compression_ratio(jax.tree.map(jnp.asarray, p), bits)
    bf = params_from_numpy(p, "cpu", torch.bfloat16)
    assert comp.compression_ratio(bf) == jcomp.compression_ratio(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p))


def test_three_compressed_train_steps_match_jax():
    """--compress on shared weights: the reduced qwen3 in f32, three
    steps of the port's compressed step against the JAX one."""
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              dtype="float32")
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 2, 3), clip_norm=1.0)
    opt = adamw.AdamW(lr=adamw.cosine_schedule(1e-3, 2, 3), clip_norm=1.0)
    jstate = JTL.init_state(jcfg, jopt, jax.random.PRNGKey(0), compress=True)
    state = TL.TrainState(
        params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu"),
        adamw_state_from_numpy(jax.tree.map(np.asarray, jstate.opt), "cpu"),
        comp.init_ef(params_from_numpy(
            jax.tree.map(np.asarray, jstate.params), "cpu")))
    jstep = jax.jit(JTL.make_train_step(jcfg, jopt, compress=True,
                                        policy=PALLAS))
    step = TL.make_train_step(cfg, opt, compress=True)
    data = JSyntheticLM(vocab=cfg.vocab, seq_len=32, batch=2, seed=0)
    for i in range(3):
        b = data.batch_at(i)
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, met = step(state, {k: torch.from_numpy(v).long()
                                  for k, v in b.items()})
        assert abs(float(met["loss"]) - float(jmet["loss"])) < 1e-4, i
    want = jax.tree_util.tree_flatten_with_path(jstate.params)[0]
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), state.params))
    for (path, w), x in zip(want, got):
        assert np.abs(np.asarray(w) - x).max() < 5e-3, path
    errs = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), state.ef.error))
    assert all(np.isfinite(e).all() for e in errs)


# -- the launcher, the meshes and the dry-run's stand-ins --------------------

CLI = ["--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
       "--seq", "32"]


def test_launcher_compress_runs_in_a_world_of_one():
    """--compress runs; step 0's loss is the uncompressed run's bit for
    bit (compression acts after the loss); the world of 1 it started is
    gone after it returns."""
    import torch.distributed as dist
    plain = train_cli.main(CLI)
    packed = train_cli.main(CLI + ["--compress", "--model-parallel", "1"])
    assert len(packed) == 3 and all(np.isfinite(packed))
    assert packed[0] == plain[0] and packed[1:] != plain[1:]
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        train_cli.main(CLI + ["--model-parallel", "2"])
    assert not dist.is_initialized()


def test_host_mesh_world_of_one():
    import torch.distributed as dist
    with mesh_lib.host_mesh(1, "cpu") as mesh:
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1) and dist.get_backend() == "gloo"
        assert ctx.model_group(mesh) is None and ctx.data_groups(mesh) == []
    assert not dist.is_initialized()
    assert mesh_lib.dp_axes(True) == ("pod", "data")
    assert mesh_lib.dp_axes(False) == ("data",)
    assert mesh_lib.backend_for("cuda") == "nccl"


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_are_the_reference_stand_ins(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    from torch._subclasses.fake_tensor import FakeTensor
    for jcell, cell in zip(JSHAPES, SHAPES):
        assert S.applicable(cfg, cell) == JS.applicable(jcfg, jcell)
        for jb, tb in ((JS.train_batch_specs(jcfg, jcell),
                        S.train_batch_specs(cfg, cell)),
                       (JS.prefill_batch_specs(jcfg, jcell),
                        S.prefill_batch_specs(cfg, cell))):
            assert jb.keys() == tb.keys()
            for k in jb:
                assert isinstance(tb[k], FakeTensor)
                assert tuple(tb[k].shape) == tuple(jb[k].shape)
                assert str(tb[k].dtype).split(".")[-1] == str(jb[k].dtype)
            for dp in (16, 32):
                want = JS.batch_pspec(jb, multi_pod=dp == 32, dp=dp)
                got = S.batch_pspec(tb, multi_pod=dp == 32, dp=dp)
                assert {k: tuple(v) for k, v in got.items()} == \
                    {k: tuple(v) for k, v in want.items()}
        token, pos, _ = S.decode_inputs(cfg, cell)
        jtoken, _, _ = JS.decode_inputs(jcfg, jcell)
        assert tuple(token.shape) == tuple(jtoken.shape)
        assert pos == cell.seq_len - 1


def test_dryrun_skips_what_applicable_skips():
    _, rj = dryrun.lower_cell("qwen3-0.6b", "long_500k")
    want = JS.applicable(jax_get_config("qwen3-0.6b"),
                         [s for s in JSHAPES if s.name == "long_500k"][0])
    assert rj == {"arch": "qwen3-0.6b", "shape": "long_500k",
                  "skipped": True, "reason": want[1]}
