"""The port's autotuner (`repro_torch.tuning`) against the JAX package's
where both run on the CPU, and its mechanics: the shapes a model's step
runs, the cache keys and file (one file with the reference's entries),
fingerprints, the candidate spaces (one k-order, the static plan first),
the sweep and warm_start with an injected timer, the plan functions
serving a set cache, tuning refused on the CPU, and the launchers'
--backend / --autotune.

No kernel runs here: the sweeps' candidates are timed by a timer that
does not call them, and the CLI runs take the plain versions."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.core.blocking import BlockConfig
from repro.tuning import autotuner as jax_autotuner
from repro.tuning import cache as jax_cache

from repro_torch import tuning
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import hw
from repro_torch.kernels import matmul as tmm
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.serving import ServingEngine
from repro_torch.tuning import autotuner, cache as tcache, space, timing


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    """Point the process cache at a throwaway file; no setting left on."""
    path = str(tmp_path / "tuning.json")
    monkeypatch.setenv(tcache.CACHE_ENV_VAR, path)
    tcache.reset_cache()
    yield path
    tcache.reset_cache()
    tcache.set_tuned(None)


def _fake_timer(seconds_of):
    """A timer that calls no candidate: seconds_of(i) for candidate i."""
    calls = []

    def timer(fns):
        calls.append(len(fns))
        return [seconds_of(i) for i in range(len(fns))]
    timer.calls = calls
    return timer


# -- the shapes a step runs, against the reference ------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_shapes_match_the_reference(arch):
    jc, pc = jax_get_config(arch), get_config(arch)
    for batch, seq in ((4, 1), (1, 37), (4, 512)):
        for backward in (False, True):
            for quant in (False, True):
                assert autotuner.model_gemm_shapes(
                    pc, batch, seq, backward=backward, quant=quant) == \
                    jax_autotuner.model_gemm_shapes(
                        jc, batch, seq, backward=backward, quant=quant)
            for decode_len in (None, 2048):
                assert autotuner.model_attention_shapes(
                    pc, batch, seq, backward=backward,
                    decode_len=decode_len) == \
                    jax_autotuner.model_attention_shapes(
                        jc, batch, seq, backward=backward,
                        decode_len=decode_len)
    assert autotuner.model_ssd_shapes(pc) == jax_autotuner.model_ssd_shapes(jc)


# -- keys and the file ------------------------------------------------------

KEY_CASES = [
    ("matmul_key", (4, 151936, 1024), "none"),
    ("matmul_key", (2048, 1024, 3072), "residual"),
    ("matmul_key", (4, 1536, 1536), "bias"),
    ("matmul_q_key", (4, 3072, 1024), "none"),
    ("matmul_q_key", (1500, 1536, 384), "bias_gelu"),
    ("gated_key", (4, 3072, 1024), None),
    ("flash_key", (512, 512, 128), None),
    ("flash_bwd_key", (512, 512, 128), None),
    ("flash_decode_key", (2048, 128), None),
    ("flash_decode_paged_key", (16, 128), None),
    ("ssd_key", (256, 64, 128), None),
]


@pytest.mark.parametrize("fn, shape, epilogue", KEY_CASES)
def test_keys_are_the_references_with_the_cuda_tag(fn, shape, epilogue):
    for pdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, "float32")):
        kw = {} if epilogue is None else {"epilogue": epilogue}
        want = getattr(jax_cache, fn)(*shape, jdt, "cuda", **kw)
        assert getattr(tcache, fn)(*shape, pdt, "cuda", **kw) == want
        assert getattr(tcache, fn)(*shape, pdt, **kw) == want
        assert want.split("|")[3] == "cuda"


def test_a_jax_written_file_keeps_its_entries(tmp_path):
    path = str(tmp_path / "shared.json")
    j = jax_cache.TuningCache(path, fingerprint="tpu-v5e|cpu|cpu|jax-x")
    j.put_matmul(512, 512, 512, "float32", "pallas",
                 BlockConfig(256, 128, 512), time_us=10.0, speedup=1.5)
    j.save()
    p = tcache.TuningCache(path).load()
    assert len(p) == 0
    p.put_matmul(4, 1024, 2048, torch.bfloat16, tmm._ROWS16_N32,
                 time_us=9.0, baseline_us=10.0, speedup=1.1111)
    p.save()
    doc = json.load(open(path))
    assert doc["version"] == 1
    assert set(doc["caches"]) == {"tpu-v5e|cpu|cpu|jax-x", hw.fingerprint()}
    j2 = jax_cache.TuningCache(path, fingerprint="tpu-v5e|cpu|cpu|jax-x")
    assert j2.load().get_matmul(512, 512, 512, "float32", "pallas") == \
        BlockConfig(256, 128, 512)
    assert tcache.TuningCache(path).load().get_matmul(
        4, 1024, 2048, torch.bfloat16) == "ROWS16_N32"


def test_cache_round_trips(tmp_path):
    path = str(tmp_path / "c.json")
    c = tcache.TuningCache(path, fingerprint="fp-a")
    c.put_matmul(4, 151936, 1024, "bfloat16", tmm._ROWS16_N8,
                 time_us=100.0, baseline_us=120.0, speedup=1.2)
    c.put_gated(2048, 3072, 1024, "bfloat16", tmm._GATED_WIDE[64])
    c.put_matmul_q(4, 3072, 1024, "bfloat16", tmm._Q_ROWS16[16],
                   epilogue="residual")
    c.put_flash(512, 512, 128, "bfloat16", tcache.FlashBlockConfig(64, 64))
    c.put_ssd(256, 64, 128, "float32", tcache.SSDBlockConfig(256, 64))
    c.save()
    c2 = tcache.TuningCache(path, fingerprint="fp-a").load()
    assert c2.get_matmul(4, 151936, 1024, "bfloat16") == "ROWS16_N8"
    assert c2.get_gated(2048, 3072, 1024, "bfloat16") == "WIDE"
    assert c2.get_matmul_q(4, 3072, 1024, "bfloat16",
                           epilogue="residual") == "ROWS16_N16"
    assert c2.get_matmul_q(4, 3072, 1024, "bfloat16") is None
    assert c2.get_flash(512, 512, 128, "bfloat16") == \
        tcache.FlashBlockConfig(64, 64)
    assert c2.get_ssd(256, 64, 128, "float32") == tcache.SSDBlockConfig(256, 64)
    e = c2.entries[tcache.matmul_key(4, 151936, 1024, "bfloat16")]
    assert (e["plan"], e["bm"], e["bn"], e["bk"]) == ("ROWS16_N8", 16, 8, 256)
    assert e["speedup"] == 1.2 and e["baseline_us"] == 120.0 \
        and "tuned_at" in e


def test_a_foreign_fingerprint_misses_and_the_static_plan_holds(tmp_path):
    path = str(tmp_path / "c.json")
    other = tcache.TuningCache(path, fingerprint="h100-sxm|NVIDIA-H100|x|y")
    other.put_matmul(4, 1024, 1024, "bfloat16", tmm._WIDE192)
    other.save()
    here = tcache.TuningCache(path).load()
    assert here.get_matmul(4, 1024, 1024, "bfloat16") is None
    assert here.misses == 1 and here.hits == 0
    with tcache.tuned(here):
        assert tmm.tile_plan(4, 1024, 1024, False, False) is tmm._ROWS16_N8
    with pytest.raises(ValueError, match="never served"):
        tcache.set_tuned(other)
    assert tcache.tuned_cache() is None


def test_a_set_cache_serves_its_winners(tmp_path):
    c = tcache.TuningCache(str(tmp_path / "c.json"))
    c.put_matmul(4, 1024, 1024, "bfloat16", tmm._WIDE192)
    c.put_matmul(4, 1024, 1024, "bfloat16", tmm._ROWS16_N32,
                 epilogue="residual")
    c.put_matmul(2048, 1024, 1024, "float32", tmm._F32_64)
    c.put_matmul_q(4, 3072, 1024, "bfloat16", tmm._Q_NARROW)
    c.put_gated(2048, 3072, 1024, "bfloat16", tmm._GATED_ROWS16)
    assert tcache.tuned_cache() is None
    with tcache.tuned(c):
        assert tmm.tile_plan(4, 1024, 1024, True, True) is tmm._WIDE192
        assert tmm.tile_plan(4, 1024, 1024, False, False,
                             "residual") is tmm._ROWS16_N32
        assert tmm.tile_plan(4, 1024, 1024, False, False,
                             "bias") is tmm._ROWS16_N8       # a miss
        assert tmm.f32_tile_plan(2048, 1024, 1024) is tmm._F32_64
        assert tmm.q_tile_plan(4, 1024, 3072) is tmm._Q_NARROW
        assert tmm.gated_tile_plan(2048, 1024, 3072) is tmm._GATED_ROWS16
        assert c.hits == 5 and c.misses == 1
    assert tcache.tuned_cache() is None
    assert tmm.tile_plan(4, 1024, 1024, False, False) is tmm._ROWS16_N8


def test_an_entry_naming_no_instance_raises(tmp_path):
    c = tcache.TuningCache(str(tmp_path / "c.json"))
    c.put_gated(4, 3072, 1024, "bfloat16", tmm._WIDE192)   # not a dual GEMM's
    with tcache.tuned(c), pytest.raises(ValueError, match="no instance"):
        tmm.gated_tile_plan(4, 1024, 3072)


def test_with_the_cache_off_every_plan_is_the_static_rule():
    assert tcache.tuned_cache() is None
    for m in (1, 4, 16, 17, 128, 2048):
        for k, n in ((1024, 3072), (3072, 1024), (1024, 151936),
                     (2048, 1536)):
            assert tmm.tile_plan(m, k, n, False, True) is \
                tmm.static_plan("matmul", "bfloat16", m, k, n)
            assert tmm.f32_tile_plan(m, k, n) is \
                tmm.static_plan("matmul", "float32", m, k, n)
            assert tmm.q_tile_plan(m, k, n) is \
                tmm.static_plan("matmul_q", "bfloat16", m, k, n)
            assert tmm.gated_tile_plan(m, k, n) is \
                tmm.static_plan("gated", "bfloat16", m, k, n)


# -- candidate spaces --------------------------------------------------------

@pytest.mark.parametrize("m", [1, 4, 16, 17, 128, 2048])
def test_candidates_share_the_static_k_order_static_first(m):
    for k, n in ((1024, 3072), (3072, 1024), (1024, 151936), (77, 45)):
        for op, dt in tmm.PLANS:
            if op == "gated":
                cands = space.gated_matmul_candidates(m, n, k, dt)
            else:
                cands = space.matmul_candidates(m, n, k, dt,
                                                quant=op == "matmul_q")
            static = tmm.static_plan(op, dt, m, k, n)
            assert cands[0] is static
            assert all(c.k_order == static.k_order for c in cands)
            assert all(c in tmm.PLANS[(op, dt)] for c in cands)
            assert len({c.name for c in cands}) == len(cands)


def test_the_wide_tiles_collapse_where_tma_cannot_take_an_operand():
    names = lambda cs: sorted(c.name for c in cs)
    assert names(space.matmul_candidates(2048, 1024, 1024)) == \
        ["ROWS16_N32", "ROWS16_N8", "WIDE", "WIDE192"]
    # ldb 45 elements (B row-major [K, N]): no TMA, one 128-row tile
    assert names(space.matmul_candidates(2048, 45, 1024)) == \
        ["ROWS16_N32", "ROWS16_N8", "WIDE"]
    assert names(space.matmul_candidates(2048, 1024, 0)) == \
        ["ROWS16_N32", "ROWS16_N8", "WIDE"]
    assert names(space.gated_matmul_candidates(2048, 3072, 1024)) == \
        ["ROWS16_N16", "WIDE", "WIDE256"]
    assert names(space.gated_matmul_candidates(2048, 3072, 77)) == \
        ["ROWS16_N16", "WIDE256"]      # the static plan stands for both
    assert names(space.matmul_candidates(4, 3072, 1024, quant=True)) == \
        ["ROWS16_N16", "ROWS16_N8", "WIDE"]
    assert len(space.matmul_candidates(2048, 1024, 1024,
                                       max_candidates=2)) == 2


def test_the_attention_and_ssd_spaces_hold_one_instance():
    for cands in (space.flash_candidates(512, 512, 128),
                  space.flash_bwd_candidates(512, 512, 128),
                  space.flash_decode_candidates(2048, 128),
                  space.flash_decode_paged_candidates(16, 128),
                  space.ssd_candidates(256, 64, 128)):
        assert len(cands) == 1
    assert space.flash_decode_candidates(2048, 128)[0].bk == 64


# -- the sweep -----------------------------------------------------------------

def test_sweep_picks_the_minimum_against_the_static_plan(tmp_path):
    c = tcache.TuningCache(str(tmp_path / "c.json"), fingerprint="fp")
    cands = space.matmul_candidates(4, 3072, 1024)
    times = [40e-6, 30e-6, 25e-6, 35e-6]
    timer = _fake_timer(lambda i: times[i])
    res = autotuner._sweep(
        "matmul", "test", cands, lambda p: lambda: None,
        lambda p, meta: c.put_matmul(4, 3072, 1024, "bfloat16", p, **meta),
        c, False, timer)
    assert timer.calls == [len(cands)]
    assert res.best is cands[2] and res.baseline is cands[0]
    assert res.speedup == pytest.approx(40 / 25)
    e = c.entries[res.key]
    assert e["plan"] == cands[2].name and e["time_us"] == 25.0
    assert e["baseline_us"] == 40.0 and e["speedup"] == 1.6
    tie = autotuner._sweep(
        "matmul", "tie", cands, lambda p: lambda: None,
        lambda p, meta: c.put_matmul(4, 3072, 1024, "bfloat16", p, **meta),
        c, False, _fake_timer(lambda i: 1e-5))
    assert tie.best is cands[0] and tie.speedup == 1.0


def test_tune_matmul_fills_the_cache_with_an_injected_timer(tmp_cache):
    res = autotuner.tune_matmul(20, 96, 64, "bfloat16", epilogue="residual",
                                device="cpu",
                                timer=_fake_timer(lambda i: 1.0 / (i + 1)))
    served = tcache.TuningCache(tmp_cache).load().get_matmul(
        20, 96, 64, "bfloat16", epilogue="residual")
    assert served == res.best.name and res.best is res.trials[-1][0]
    q = autotuner.tune_matmul(4, 96, 64, "bfloat16", quant="int8",
                              device="cpu", timer=_fake_timer(float),
                              save=False)
    assert q.op == "matmul_q" and q.best is tmm._Q_ROWS16[8]
    with pytest.raises(ValueError, match="quant"):
        autotuner.tune_matmul(4, 96, 64, quant="fp8", device="cpu",
                              timer=_fake_timer(float))


def test_tune_matmul_times_each_candidate_in_every_layout(tmp_cache):
    layouts = [(False, True, "float32"), (True, False, None)]
    timer = _fake_timer(lambda i: 1.0 / (i + 1))
    res = autotuner.tune_matmul(2048, 1024, 64, "bfloat16", layouts=layouts,
                                device="cpu", timer=timer, save=False)
    assert res.layouts == tuple(layouts)
    assert [c for c, _ in res.trials] == space.matmul_candidates(
        2048, 1024, 64, layouts=layouts)
    assert res.best is res.trials[-1][0] and timer.calls == [len(res.trials)]
    # TMA takes the wide tiles' operands in one layout of the two: both stay
    assert {"WIDE", "WIDE192"} <= {c.name for c in space.matmul_candidates(
        2048, 45, 1024, layouts=[(False, False, None), (False, True, None)])}
    with pytest.raises(ValueError, match="row-major"):
        autotuner.tune_matmul(4, 96, 64, quant="int8", layouts=layouts,
                              device="cpu", timer=timer)


def _record_gemms(monkeypatch):
    """Record each GEMM the port's model calls through `kernels.ops` as
    (entry, (a_km, b_nk, out dtype name)), as the kernel would read its
    operands (`kernels.matmul._layout`), then run the plain version."""
    from repro_torch.kernels import ops
    seen = set()
    matmul, gated = ops.matmul, ops.gated_matmul
    name = lambda dt: str(dt).removeprefix("torch.")

    def rec_matmul(a, b, *, out_dtype=None, epilogue="none", **kw):
        seen.add((("matmul", a.shape[0], b.shape[1], a.shape[1], epilogue),
                  (a.stride(1) != 1, b.stride(1) != 1,
                   name(out_dtype or a.dtype))))
        return matmul(a, b, out_dtype=out_dtype, epilogue=epilogue, **kw)

    def rec_gated(x, wg, wu):
        seen.add((("gated", x.shape[0], wg.shape[1], x.shape[1], "-"),
                  (False, False, name(x.dtype))))
        return gated(x, wg, wu)
    monkeypatch.setattr(ops, "matmul", rec_matmul)
    monkeypatch.setattr(ops, "gated_matmul", rec_gated)
    return seen


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen1.5-32b"])
def test_model_gemm_layouts_are_the_layouts_the_step_runs(arch, monkeypatch):
    """Every GEMM of a train step (forward and backward) runs in a layout
    model_gemm_layouts gives its entry, and every layout it gives an
    entry the step runs is run (tied logits: the table in place, f32
    out; dA on W's transpose view, dW on X's)."""
    from repro_torch.core.tree import leaves
    cfg = get_config(arch, reduced=True)
    batch, seq = 2, 16
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for t in leaves(params):
        t.requires_grad_()
    tokens = torch.randint(0, cfg.vocab, (batch, seq),
                           generator=torch.Generator().manual_seed(1))
    seen = _record_gemms(monkeypatch)
    loss, _ = M.loss_fn(cfg, params, {"tokens": tokens, "labels": tokens})
    loss.backward()
    ran = {}
    for entry, layout in seen:
        ran.setdefault(entry, set()).add(layout)
    declared = autotuner.model_gemm_layouts(cfg, batch, seq, backward=True)
    assert set(ran) <= set(declared), set(ran) - set(declared)
    for entry, layouts in declared.items():
        want = {(t_a, t_b, out or cfg.dtype) for t_a, t_b, out in layouts}
        assert ran.get(entry, {(False, False, cfg.dtype)}) == want, entry
    logits = ("matmul", batch * seq, cfg.padded_vocab, cfg.d_model, "none")
    assert (False, cfg.tie_embeddings, "float32") in declared[logits]
    assert set(autotuner.model_gemm_layouts(cfg, 4, 1)) == \
        set(autotuner.model_gemm_shapes(cfg, 4, 1))


def test_warm_start_reports_misses_then_hits(tmp_cache):
    cfg = get_config("qwen3-0.6b", reduced=True)
    rep = autotuner.warm_start(cfg, 2, [16, 1], backward=True,
                               decode_len=64, device="cpu")
    shapes = set(autotuner.model_gemm_shapes(cfg, 2, 16, backward=True)) \
        | set(autotuner.model_gemm_shapes(cfg, 2, 1, backward=True))
    fixed = set(autotuner.model_attention_shapes(cfg, 2, 16, backward=True,
                                                 decode_len=64)) \
        | set(autotuner.model_attention_shapes(cfg, 2, 1, decode_len=64))
    assert rep["hits"] == [] and rep["tuned"] == []
    assert set(rep["misses"]) == shapes and set(rep["fixed"]) == fixed
    assert {e[0] for e in rep["fixed"]} == {"flash", "flash_bwd",
                                            "flash_decode"}
    assert "gated" in {e[0] for e in rep["misses"]}
    timer = _fake_timer(lambda i: 2.0 - i / 10)
    rep2 = autotuner.warm_start(cfg, 2, [16, 1], backward=True,
                                decode_len=64, autotune=True, device="cpu",
                                timer=timer)
    assert sorted(rep2["tuned"]) == sorted(shapes)
    assert len(rep2["results"]) == len(timer.calls) == len(shapes)
    assert set(rep2["fixed"]) == fixed
    assert autotuner.describe_warm_start(rep2).endswith(
        f"{len(fixed)} shapes of one instance; 0 hits, 0 misses, "
        f"{len(shapes)} tuned at startup")
    layouts = autotuner.model_gemm_layouts(cfg, 2, 16, backward=True)
    for entry, res in zip(rep2["tuned"], rep2["results"]):
        if entry in layouts and entry[0] == "matmul":
            assert set(res.layouts) == set(layouts[entry]), entry
    rep3 = autotuner.warm_start(cfg, 2, [16, 1], backward=True,
                                decode_len=64, device="cpu")
    assert sorted(rep3["hits"]) == sorted(shapes) and rep3["misses"] == []
    assert rep3["fingerprint"] == hw.fingerprint()
    assert rep3["backend"] == autotuner.default_exec_backend() == "cuda"


def test_warm_start_covers_the_ssd_shape(tmp_cache):
    cfg = get_config("zamba2-1.2b", reduced=True)
    rep = autotuner.warm_start(cfg, 1, 32, device="cpu")
    assert ("ssd", cfg.ssm.chunk, cfg.ssm.head_dim, cfg.ssm.d_state,
            "-") in rep["fixed"]
    assert not any(e[0] == "ssd" for e in rep["misses"] + rep["hits"])


def test_tuning_on_the_cpu_raises(tmp_cache):
    with pytest.raises(ValueError, match="no tile to time"):
        autotuner.tune_matmul(4, 64, 64, "bfloat16", device="cpu")
    with pytest.raises(ValueError, match="no tile to time"):
        timing.time_turns([lambda: None], device="cpu")
    cfg = get_config("qwen3-0.6b", reduced=True)
    with pytest.raises(ValueError, match="no tile to time"):
        autotuner.warm_start(cfg, 1, 8, autotune=True, device="cpu")


# -- the engine and the launchers ----------------------------------------------

def test_the_engine_keeps_the_setting_of_its_construction(tmp_path,
                                                         monkeypatch):
    """An engine built under a cache serves it, and one built static the
    static plans, to everything it runs: its admission prefill (eager
    on the card) and decode steps, whatever the process's setting."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    c = tcache.TuningCache(str(tmp_path / "c.json"))
    with tcache.tuned(c):
        eng = ServingEngine(cfg, params, max_slots=1, max_len=24,
                            device="cpu")
    assert eng.tuned_cache is c and tcache.tuned_cache() is None
    static = ServingEngine(cfg, params, max_slots=1, max_len=24,
                           device="cpu")
    assert static.tuned_cache is None
    seen = []
    for name in ("prefill", "decode_step"):
        fn = getattr(M, name)
        monkeypatch.setattr(M, name, lambda *a, fn=fn, name=name, **kw: (
            seen.append((name, tcache.tuned_cache())), fn(*a, **kw))[1])
    eng.submit(np.arange(1, 11), 3)
    eng.run()
    assert {n for n, _ in seen} == {"prefill", "decode_step"}
    assert all(s is c for _, s in seen) and tcache.tuned_cache() is None
    seen.clear()
    static.submit(np.arange(1, 11), 3)
    with tcache.tuned(c):
        static.run()
        assert tcache.tuned_cache() is c
    assert {n for n, _ in seen} == {"prefill", "decode_step"}
    assert all(s is None for _, s in seen)


def test_backend_xla_is_refused(capsys):
    for cli in (serve_cli, train_cli):
        with pytest.raises(SystemExit):
            cli.main(["--reduced", "--device", "cpu", "--backend", "xla"])
        err = capsys.readouterr().err
        assert "'cuda'" in err and "'tuned'" in err and "'xla'" in err


def test_backend_tuned_serves_the_cuda_runs_streams(tmp_cache, capsys):
    argv = ["--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "12", "--gen", "6"]
    want = serve_cli.main(argv + ["--backend", "cuda"])
    got = serve_cli.main(argv + ["--backend", "tuned"])
    assert np.array_equal(got, want)
    assert "tuning cache" in capsys.readouterr().out
    assert tcache.tuned_cache() is None


def test_train_backend_tuned_gives_the_cuda_runs_losses(tmp_cache, capsys):
    argv = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
            "--seq", "16"]
    want = train_cli.main(argv)
    got = train_cli.main(argv + ["--backend", "tuned"])
    assert got == want
    assert "tuning cache" in capsys.readouterr().out
    assert tcache.tuned_cache() is None


def test_the_tuning_package_is_lazy_and_complete():
    for name in tuning.__all__:
        assert getattr(tuning, name) is not None
    assert tuning.BACKENDS == ("cuda", "tuned")
    assert tuning.check_backend("tuned") == "tuned"
    with pytest.raises(ValueError, match="'cuda', 'tuned'"):
        tuning.check_backend("pallas_interpret")
