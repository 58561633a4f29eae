"""The port's serving engine against the JAX package's, on the same
weights and trace: 4 prompts (lengths 8, 24, 13, 40; 13 runs the
prefill-remainder steps) over 2 slots, so requests 2 and 3 are admitted
mid-stream into freed slots. Greedy streams must be token-identical.

Both engines run in float32; the JAX one under
`Policy(backend="pallas", interpret=True)`, the port's on the CPU.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.policy import Policy
from repro.models import model as JM
from repro.serving import ServingEngine as JaxEngine
from repro.serving import make_sampler as jax_make_sampler
from repro.serving.workload import synthetic_trace as jax_synthetic_trace
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.serving import ServingEngine, greedy, synthetic_trace

LENGTHS = [8, 24, 13, 40]
GENS = [5, 4, 7, 6]


def _streams(engine, prompts):
    reqs = [engine.submit(p, g) for p, g in zip(prompts, GENS)]
    report = engine.run()
    assert report["n_finished"] == len(reqs)
    admitted = sorted(r.t_admitted for r in reqs)
    finished = sorted(r.t_finished for r in reqs)
    assert admitted[-1] > finished[0], "expected a mid-stream admission"
    return [r.generated for r in reqs]


def test_engine_streams_match_jax_engine():
    jcfg = dataclasses.replace(jax_get_config("qwen3-0.6b", reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen3-0.6b", reduced=True),
                              dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in LENGTHS]

    want = _streams(JaxEngine(jcfg, jparams, max_slots=2, max_len=64,
                              policy=Policy(backend="pallas", interpret=True)),
                    prompts)
    got = _streams(ServingEngine(cfg, params, max_slots=2, max_len=64,
                                 device="cpu"), prompts)
    assert got == want
    assert all(0 <= t < cfg.vocab for s in got for t in s)


def test_synthetic_trace_matches_jax_trace():
    cfg = get_config("qwen3-0.6b", reduced=True)
    kw = dict(len_range=(4, 20), gen=5, arrival_rate=3.0)
    mine = synthetic_trace(cfg, 6, rng=np.random.default_rng(3), **kw)
    ref = jax_synthetic_trace(jax_get_config("qwen3-0.6b", reduced=True), 6,
                              rng=np.random.default_rng(3), **kw)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.gen, a.arrival) == (b.gen, b.arrival)


def test_greedy_matches_jax_greedy_sampler():
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((20, 64)).astype(np.float32)
    ref = jax_make_sampler("greedy")
    assert [greedy(r) for r in rows] == [ref(r) for r in rows]


@pytest.mark.parametrize("argv", [
    ["--reduced", "--device", "cpu", "--requests", "4", "--max-slots", "2"],
    ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "12",
     "--gen", "3"],
])
def test_serve_cli_smoke(argv, capsys):
    out = serve.main(argv)
    text = capsys.readouterr().out
    assert "arch=qwen3-0.6b-reduced" in text
    if "--requests" in argv:
        assert out["n_finished"] == 4
    else:
        assert out.shape == (2, 3)


def test_submit_beyond_max_len_raises():
    cfg = get_config("qwen3-0.6b", reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServingEngine(cfg, params, max_slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.zeros(12, np.int32), 8)
