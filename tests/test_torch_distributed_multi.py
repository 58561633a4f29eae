"""The port's distributed paths in worlds of CPU processes (gloo), against
the JAX package and the port's own single-process step.

One fixture runs every world once and the tests read what it left:
  * a world of 4 (`torch.multiprocessing`, a FileStore): the three
    schedules of `sharded_matmul` over a 4-wide "model" axis; each at
    p = 1 (no mesh, and a 4 x 1 mesh) against the GEMM chokepoint; three
    train steps of the reduced qwen3 on a 2 data x 2 model mesh, plain and
    with --compress; a checkpoint of that state written by all 4 ranks;
    one counted step's collectives; a DTensor under `constrain`;
  * a world of 2: the 4-rank checkpoint and one written by the JAX
    package restored onto a 1 x 2 mesh (`restore(shardings=)`);
  * the JAX `sharded_matmul` on a 4-device host mesh, in a subprocess as
    tests/test_distributed.py runs it, and the JAX single-device train
    step, here;
  * the dry-run on a fake 16x16 process group, in a subprocess.

Stated tolerances (f32 throughout; the reduced qwen3 in f32, its weights
drawn by the JAX package and bridged): the schedules within 1e-4 of the
JAX ones relative to the product's largest entry (a K-split sums in
another order), and bit for bit at p = 1; the train steps' losses within
1e-4 and params within 5e-3 of the single-process steps (the reference
test's bound); checkpoints bit for bit. The reference's own multi-device
step test fails by its 1e-3 loss bound in bf16 (ROADMAP queue 3); in f32
it holds, and so the port is held to the single-device step in f32.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core import distributed as D
from repro_torch.core import gemm
from repro_torch.core.tree import tree_map
from repro_torch.distributed import compression as comp
from repro_torch.distributed import context as ctx
from repro_torch.distributed import sharding as SH
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWState
from repro_torch.roofline import counter
from repro_torch.training import train_loop as TL

ROOT = Path(__file__).resolve().parents[1]
STEPS, BATCH, SEQ = 3, 4, 32
SCHEDULES = ("ring", "column", "row")


def _cfg():
    return dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                               dtype="float32")


def _mqa_cfg():
    return dataclasses.replace(get_config("granite-20b", reduced=True),
                               dtype="float32")


def _opt():
    return adamw.AdamW(lr=adamw.cosine_schedule(1e-3, 2, STEPS),
                       clip_norm=1.0)


def _flat(tree):
    out = {}
    SH._map_paths(lambda ps, x: out.__setitem__(ps, x), tree)
    return out


def _unflat(flat):
    tree = {}
    for path, x in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.from_numpy(np.array(x))
    return tree


def _batches(d):
    z = np.load(d / "batches.npz")
    return [{"tokens": torch.from_numpy(z[f"tokens{i}"]).long(),
             "labels": torch.from_numpy(z[f"labels{i}"]).long()}
            for i in range(STEPS)]


def _steps(state, batches, mesh, compress):
    step = TL.make_train_step(_cfg(), _opt(), compress=compress, mesh=mesh)
    losses = []
    for b in batches:
        state, met = step(state, b)
        losses.append(float(met["loss"]))
    return state, losses


def _train(cfg, state, batches, mesh):
    """The losses of steps from `state` (carried) on `batches`."""
    step, losses = TL.make_train_step(cfg, _opt(), mesh=mesh), []
    for b in batches:
        state, met = step(state, b)
        losses.append(float(met["loss"]))
    return losses


def _init(d, mesh, compress):
    """The bridged JAX params, cut to this rank's blocks on `mesh`."""
    whole = _unflat(np.load(d / "params.npz"))
    if mesh is not None:
        layout = SH.model_layout(_cfg(), whole, mesh)
        whole = tree_map(lambda s, x: SH.Sharding(mesh, s).local(x).clone(),
                         layout, whole)
    return TL.TrainState(whole, _opt().init(whole),
                         comp.init_ef(whole) if compress else None)


def _gathered(state, mesh, d):
    layout = SH.model_layout(_cfg(), _unflat(np.load(d / "params.npz")),
                             mesh)
    return {p: x.numpy() for p, x in _flat(tree_map(
        lambda s, x: SH.Sharding(mesh, s).gather(x), layout,
        state.params)).items()}


def _world4(rank, d):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    d = Path(d)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "s4"), 4),
                            rank=rank, world_size=4)
    out = {}
    try:
        z = np.load(d / "mm.npz")
        a, b = torch.from_numpy(z["a"]), torch.from_numpy(z["b"])
        mesh14 = init_device_mesh("cpu", (1, 4),
                                  mesh_dim_names=("data", "model"))
        mesh41 = init_device_mesh("cpu", (4, 1),
                                  mesh_dim_names=("data", "model"))
        whole = gemm.matmul(a, b)
        for s in SCHEDULES:
            np.save(d / f"mm_{s}_{rank}.npy",
                    D.sharded_matmul(a, b, mesh14, schedule=s).numpy())
            out[f"p1_{s}"] = (
                torch.equal(D.sharded_matmul(a, b, None, schedule=s), whole)
                and torch.equal(D.sharded_matmul(a, b, mesh41, schedule=s),
                                whole))

        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        batches = _batches(d)
        for compress in (False, True):
            state, losses = _steps(_init(d, mesh, compress), batches, mesh,
                                   compress)
            out[f"losses_{compress}"] = losses
            params = _gathered(state, mesh, d)
            if rank == 0:
                np.savez(d / f"tp_params_{compress}.npz", **params)
            if not compress:
                sh = tree_map(lambda s: SH.Sharding(mesh, s),
                              SH.model_layout(_cfg(), _unflat(np.load(
                                  d / "params.npz")), mesh))
                Checkpointer(str(d / "ck4")).save(
                    STEPS, state, shardings=TL.TrainState(
                        sh, AdamWState(SH.Sharding(mesh, SH.P()), sh, sh)))
                tp_state = state

        # MQA: granite-20b's one KV head, replicated over "model"
        mqa = _mqa_cfg()
        state = TL.init_state(mqa, _opt(), torch.Generator().manual_seed(0),
                              "cpu", mesh=mesh)
        out["losses_mqa"] = _train(mqa, state, batches, mesh)

        # one counted step: its collectives, by the ring model
        with counter.count() as costs:
            _steps(tp_state, batches[:1], mesh, False)
        out["collectives"] = [dataclasses.asdict(c)
                              for c in costs.collectives]
        out["ici_bytes"] = costs.ici_bytes

        x = torch.arange(48.0).reshape(8, 6)
        sh = SH.Sharding(mesh, SH.P("data", "model"))
        out["placements"] = torch.equal(
            distribute_tensor(x, mesh, sh.placements()).to_local(),
            sh.local(x))
        dt = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        with ctx.mesh_context(mesh):
            y = ctx.constrain(dt, "dp", "tp")
        out["constrain"] = (list(map(str, y.placements)),
                            list(y.to_local().shape),
                            bool(torch.equal(y.full_tensor(), x)))
    finally:
        dist.destroy_process_group()
    with open(d / f"out4_{rank}.json", "w") as f:
        json.dump(out, f)


def _world2(rank, d):
    from torch.distributed.device_mesh import init_device_mesh
    d = Path(d)
    dist.init_process_group("gloo", store=dist.FileStore(str(d / "s2"), 2),
                            rank=rank, world_size=2)
    out = {}
    try:
        mesh = init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))
        whole = _unflat(np.load(d / "params.npz"))
        layout = SH.model_layout(_cfg(), whole, mesh)
        sh = tree_map(lambda s: SH.Sharding(mesh, s), layout)
        like = TL.TrainState(whole, _opt().init(whole))
        got = Checkpointer(str(d / "ck4")).restore(
            STEPS, like, shardings=TL.TrainState(
                sh, AdamWState(SH.Sharding(mesh, SH.P()), sh, sh)))
        want = _unflat(np.load(d / "tp_params_False.npz"))
        out["from_4"] = all(
            torch.equal(SH.Sharding(mesh, s).local(w), g)
            for s, w, g in zip(_flat(layout).values(), _flat(want).values(),
                               _flat(got.params).values()))
        out["from_4_shapes"] = sorted({str(tuple(x.shape)) for x in
                                       _flat(got.params).values()})
        out["step"] = int(got.opt.step)
        jgot = Checkpointer(str(d / "ckjax")).restore(1, whole, shardings=sh)
        jwant = _unflat(np.load(d / "jax_params.npz"))
        out["from_jax"] = all(
            torch.equal(SH.Sharding(mesh, s).local(w), g)
            for s, w, g in zip(_flat(layout).values(), _flat(jwant).values(),
                               _flat(jgot).values()))
    finally:
        dist.destroy_process_group()
    with open(d / f"out2_{rank}.json", "w") as f:
        json.dump(out, f)


JAX_MM = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, "src")
import numpy as np, jax, jax.numpy as jnp
from repro.core.distributed import sharded_matmul
from repro.launch.mesh import axis_kw
mesh = jax.make_mesh((4,), ("model",), **axis_kw(1))
z = np.load(sys.argv[1] + "/mm.npz")
for s in ("ring", "column", "row"):
    np.save(sys.argv[1] + f"/jax_mm_{s}.npy", np.asarray(
        sharded_matmul(jnp.asarray(z["a"]), jnp.asarray(z["b"]), mesh,
                       schedule=s)))
"""

DRYRUN = """
import json, sys
sys.path.insert(0, "src")
from repro_torch.launch import dryrun
costs, rj = dryrun.lower_cell("qwen3-0.6b", "train_4k",
                              overrides={"n_layers": 2}, verbose=False)
out = {"report": rj, "collectives": [
    [c.op, c.bytes_result, c.group_size, c.count] for c in costs.collectives]}
out["skipped"] = {a: dryrun.lower_cell(a, "train_4k")[1]
                  for a in ("mixtral-8x22b", "qwen1.5-32b", "mamba2-2.7b")}
reports = dryrun.main(["--arch", "qwen3-0.6b", "--shape", "train_4k",
                       "--out", sys.argv[1]])
json.dump(out, open(sys.argv[1] + "/dryrun.json", "w"))
"""


def _sub(code, d):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                             str(d)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(proc, what):
    out, err = proc.communicate(timeout=420)
    assert proc.returncode == 0, (what, err[-3000:])
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro.configs import get_config as jax_get_config
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.distributed.sharding import _path_str
    from repro.optim import adamw as jadamw
    from repro.training import train_loop as JTL

    d = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    np.savez(d / "mm.npz", a=rng.normal(size=(256, 128)).astype(np.float32),
             b=rng.normal(size=(128, 64)).astype(np.float32))
    dry = _sub(DRYRUN, d)
    jmm = _sub(JAX_MM, d)

    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", reduced=True),
                               dtype="float32")
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-3, 2, STEPS),
                        clip_norm=1.0)
    jstate = JTL.init_state(jcfg, jopt, jax.random.PRNGKey(0))
    flat = {_path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    np.savez(d / "params.npz", **flat)
    JCheckpointer(str(d / "ckjax")).save(1, jstate.params)
    np.savez(d / "jax_params.npz", **flat)
    data = JSyntheticLM(vocab=jcfg.vocab, seq_len=SEQ, batch=BATCH, seed=0)
    raw = [data.batch_at(i) for i in range(STEPS)]
    np.savez(d / "batches.npz", **{f"{k}{i}": b[k] for i, b in enumerate(raw)
                                   for k in ("tokens", "labels")})

    mp.start_processes(_world4, args=(str(d),), nprocs=4,
                       start_method="spawn")
    mp.start_processes(_world2, args=(str(d),), nprocs=2,
                       start_method="spawn")

    jstep = jax.jit(JTL.make_train_step(jcfg, jopt))
    jlosses = []
    for b in raw:
        jstate, met = jstep(jstate, jax.tree.map(jnp.asarray, b))
        jlosses.append(float(met["loss"]))
    jparams = {_path_str(p): np.asarray(x) for p, x in
               jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    single = {}
    for compress in (False, True):
        state, losses = _steps(_init(d, None, compress), _batches(d), None,
                               compress)
        single[compress] = (losses, {p: x.numpy() for p, x in
                                     _flat(state.params).items()})
    mqa = _mqa_cfg()
    assert mqa.n_kv_heads == 1
    state = TL.init_state(mqa, _opt(), torch.Generator().manual_seed(0), "cpu")
    single["mqa"] = _train(mqa, state, _batches(d), None)
    _wait(jmm, "jax sharded_matmul")
    _wait(dry, "dry-run")
    out4 = [json.loads((d / f"out4_{r}.json").read_text()) for r in range(4)]
    out2 = [json.loads((d / f"out2_{r}.json").read_text()) for r in range(2)]
    return dict(d=d, out4=out4, out2=out2, jlosses=jlosses, jparams=jparams,
                single=single,
                dry=json.loads((d / "dryrun.json").read_text()))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_matmul_matches_jax_on_four_ranks(worlds, schedule):
    d = worlds["d"]
    want = np.load(d / f"jax_mm_{schedule}.npy")
    got = [np.load(d / f"mm_{schedule}_{r}.npy") for r in range(4)]
    z = np.load(d / "mm.npz")
    assert np.abs(want - z["a"] @ z["b"]).max() < 1e-3
    scale = np.abs(want).max()
    for g in got:                       # every rank holds the whole product
        assert g.shape == want.shape
        assert np.abs(g - want).max() <= 1e-4 * scale, schedule
        assert np.array_equal(g, got[0])


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_matmul_at_one_rank_gives_the_chokepoints_bits(worlds,
                                                               schedule):
    assert all(o[f"p1_{schedule}"] for o in worlds["out4"])


@pytest.mark.parametrize("compress", [False, True])
def test_two_by_two_train_step_matches_single_process(worlds, compress):
    """2 data x 2 model against the port's single-process step (with
    --compress too: a sharded leaf's scale is the whole leaf's)."""
    want_losses, want = worlds["single"][compress]
    for o in worlds["out4"]:
        np.testing.assert_allclose(o[f"losses_{compress}"], want_losses,
                                   atol=1e-4, rtol=0)
    got = np.load(worlds["d"] / f"tp_params_{compress}.npz")
    assert set(got.files) == set(want)
    for k in want:
        assert np.abs(got[k] - want[k]).max() < 5e-3, k


def test_replicated_kv_heads_match_single_process(worlds):
    """granite-20b's MQA: every rank's query heads read the one KV head,
    whose weights (replicated) take the gradient summed over "model"."""
    for o in worlds["out4"]:
        np.testing.assert_allclose(o["losses_mqa"], worlds["single"]["mqa"],
                                   atol=1e-4, rtol=0)


def test_two_by_two_train_step_matches_jax_single_device(worlds):
    for o in worlds["out4"]:
        np.testing.assert_allclose(o["losses_False"], worlds["jlosses"],
                                   atol=1e-4, rtol=0)
    got = np.load(worlds["d"] / "tp_params_False.npz")
    for k, w in worlds["jparams"].items():
        assert np.abs(got[k] - w).max() < 5e-3, k


def test_restore_onto_another_world_bit_for_bit(worlds):
    """A checkpoint written by 4 ranks (2 x 2) and one written by the JAX
    package, each laid out on a 1 x 2 mesh of a world of 2."""
    for o in worlds["out2"]:
        assert o["from_4"] and o["from_jax"] and o["step"] == STEPS
    # rank 0's blocks: the model axis halves wq's columns, wo's rows
    shapes = worlds["out2"][0]["from_4_shapes"]
    assert "(2, 64, 32)" in shapes and "(2, 32, 64)" in shapes


def test_counted_step_charges_its_collectives(worlds):
    o = worlds["out4"][0]
    ops = {c["op"] for c in o["collectives"]}
    assert {"all-reduce", "all-gather"} >= ops and "all-reduce" in ops
    assert {c["group_size"] for c in o["collectives"]} == {2}
    ring = sum(_ring_model(c["op"], c["bytes_result"], c["group_size"])
               * c["count"] for c in o["collectives"])
    assert o["ici_bytes"] == pytest.approx(ring, rel=1e-12) and ring > 0


def test_constrain_redistributes_a_dtensor(worlds):
    """constrain's placements; a Sharding's block is a DTensor's of the
    same spec."""
    for o in worlds["out4"]:
        placements, local, same = o["constrain"]
        assert placements == ["S(0)", "S(1)"] and local == [4, 3] and same
        assert o["placements"]


def _ring_model(op, n, p):
    if p <= 1:
        return 0.0
    return {"all-reduce": 2 * n * (p - 1) / p, "all-gather": n * (p - 1) / p,
            "reduce-scatter": n * (p - 1), "collective-permute": n}[op]


def test_dryrun_counts_a_16x16_step(worlds):
    dry = worlds["dry"]
    rep = dry["report"]
    assert rep["n_devices"] == 256 and rep["mesh"] == "16x16"
    want = sum(_ring_model(op, n, p) * c for op, n, p, c in dry["collectives"])
    assert rep["ici_bytes_per_device"] > 0
    assert rep["ici_bytes_per_device"] == pytest.approx(want, rel=1e-12)
    assert rep["t_collective"] > 0 and "NVLink" in rep["note"]
    assert {p for _, _, p, _ in dry["collectives"]} == {16}
    full = json.loads((worlds["d"] / "qwen3-0.6b__train_4k__singlepod.json")
                      .read_text())
    assert full["n_devices"] == 256 and full["t_collective"] > 0


def test_dryrun_writes_uncovered_cells_as_skipped(worlds):
    sk = worlds["dry"]["skipped"]
    assert sk["mixtral-8x22b"]["skipped"] and "ROADMAP.md queue 1" in \
        sk["mixtral-8x22b"]["reason"]
    assert sk["mamba2-2.7b"]["skipped"]
    assert sk["qwen1.5-32b"]["skipped"] and "n_heads 40" in \
        sk["qwen1.5-32b"]["reason"]
