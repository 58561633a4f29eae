"""qwen2-vl-2b (family vlm) in the port against the JAX package: M-RoPE in
`layers.apply_rope` at the reduced and the full config's sections, text
positions (t = h = w) giving plain RoPE's bits, the patch embeddings and
(t, h, w) positions moving the logits, and the serving engine's greedy
streams against the JAX engine's, token for token, at `qwen2-vl-2b
--reduced` on `tests/test_serving.py`'s trace (prompts 8, 16, 13, 24 over
2 slots): on a dense cache, a bf16 and an int8 page pool, and as a
speculative target with itself as the draft.

Float32 reduced configs for both packages, the JAX package's weights
bridged into the port with the QKV biases drawn from a seed (both
packages start them at zeros); the JAX side under `Policy(backend=
"pallas", interpret=True)`. Tolerance: 1e-6 on a rotation; streams token
for token.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.policy import Policy
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import ServingEngine as JaxEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.data.pipeline import multimodal_prompt
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving import ServingEngine

PALLAS = Policy(backend="pallas", interpret=True)
LENGTHS = [8, 16, 13, 24]           # tests/test_serving.py CASES["qwen2-vl-2b"]
GENS = [5, 4, 7, 6]
THETA = 1_000_000.0


def random_biases(jparams, seed):
    """The JAX tree with every "b" leaf (the QKV biases) drawn from a
    normal of scale 0.1, seeded."""
    rng = np.random.default_rng(seed)

    def rec(node):
        return {k: (jnp.asarray(rng.standard_normal(v.shape) * 0.1, v.dtype)
                    if k == "b" else rec(v) if isinstance(v, dict) else v)
                for k, v in node.items()}
    return rec(jparams)


@pytest.mark.parametrize("sections,head_dim", [((2, 3, 3), 16),
                                               ((16, 24, 24), 128)])
def test_mrope_matches_jax(sections, head_dim):
    """(B, T, 3) positions of an image's patches and of text, each
    section of the head_dim / 2 frequency slots turned by its stream."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 3, head_dim)).astype(np.float32)
    pos = rng.integers(0, 2000, (2, 6, 3)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), THETA, sections)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), THETA,
                       sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("sections,head_dim", [((2, 3, 3), 16),
                                               ((16, 24, 24), 128)])
def test_text_positions_are_plain_rope_bit_for_bit(sections, head_dim):
    """t = h = w = p turns every slot by p: plain RoPE's bits, in f32
    and in bf16; a (B, T, 3) position without sections is refused."""
    rng = np.random.default_rng(1)
    pos = torch.from_numpy(rng.integers(0, 5000, (2, 7)).astype(np.int32))
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(2, 7, 4, head_dim, generator=torch.Generator()
                        .manual_seed(2)).to(dtype)
        plain = L.apply_rope(x, pos, THETA)
        mrope = L.apply_rope(x, pos[..., None].expand(2, 7, 3), THETA,
                             sections)
        assert torch.equal(plain, mrope), dtype
    with pytest.raises(ValueError, match="mrope_sections"):
        L.apply_rope(x, pos[..., None].expand(2, 7, 3), THETA)


@pytest.fixture(scope="module")
def vlm():
    jcfg = dataclasses.replace(jax_get_config("qwen2-vl-2b", reduced=True),
                               dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-vl-2b", reduced=True),
                              dtype="float32")
    jparams = random_biases(JM.init_params(jcfg, jax.random.PRNGKey(0)), 1)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in LENGTHS]
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                prompts=prompts)


def test_patch_embeds_and_positions_move_the_logits(vlm):
    """The multimodal batch's logits differ from the same tokens' without
    patch embeddings, and from the same without the (t, h, w) positions
    (each input is read); at text positions t = h = w = i and no patch
    embeddings they equal the plain batch's bit for bit."""
    cfg, params = vlm["cfg"], vlm["params"]
    b = multimodal_prompt(np.random.default_rng(3), cfg.vocab, cfg.d_model,
                          batch=2, before=4, grid=(4, 4), after=4)
    tokens = torch.from_numpy(b["tokens"]).long()
    embeds = torch.from_numpy(b["patch_embeds"])
    positions = torch.from_numpy(b["positions"]).long()
    full = M.forward(cfg, params, {"tokens": tokens, "patch_embeds": embeds,
                                   "positions": positions})
    no_patch = M.forward(cfg, params, {"tokens": tokens,
                                       "positions": positions})
    no_pos = M.forward(cfg, params, {"tokens": tokens, "patch_embeds": embeds})
    plain = M.forward(cfg, params, {"tokens": tokens})
    text = torch.arange(tokens.shape[1])[None, :, None].expand(2, -1, 3)
    assert (full - no_patch).abs().max() > 1e-3
    assert (full - no_pos).abs().max() > 1e-3
    assert torch.equal(plain, M.forward(cfg, params, {"tokens": tokens,
                                                      "positions": text}))


LAYOUTS = {"dense": {}, "paged": dict(kv_layout="paged"),
           "paged-int8": dict(kv_layout="paged", quant_kv="int8")}


def _streams(eng, prompts):
    reqs = [eng.submit(p, g) for p, g in zip(prompts, GENS)]
    report = eng.run()
    assert report["n_finished"] == len(reqs)
    admitted = sorted(r.t_admitted for r in reqs)
    finished = sorted(r.t_finished for r in reqs)
    assert admitted[-1] > finished[0], "expected a mid-stream admission"
    return [r.generated for r in reqs], report


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_streams_match_jax_engine(vlm, layout):
    """The port's engine and the JAX engine (the same layout and KV
    quantization, pages of 8) serve the trace to the same greedy streams;
    the paged runs take the paged decode kernel's plain version."""
    lay = LAYOUTS[layout]
    pol = PALLAS.replace(kv_layout=lay.get("kv_layout", "dense"),
                         quant_kv=lay.get("quant_kv", "off"))
    want, _ = _streams(JaxEngine(vlm["jcfg"], vlm["jparams"], max_slots=2,
                                 max_len=64, page_size=8, policy=pol),
                       vlm["prompts"])
    got, report = _streams(ServingEngine(vlm["cfg"], vlm["params"],
                                         max_slots=2, max_len=64, page_size=8,
                                         device="cpu", **lay), vlm["prompts"])
    assert got == want
    assert all(0 <= t < vlm["cfg"].vocab for s in got for t in s)
    if layout != "dense":
        assert report["kv_pool"]["n_pages"] > 0


def test_spec_target_streams_match_jax_spec_engine(vlm):
    """qwen2-vl-2b as a speculative target with itself as the draft
    (spec_k 4, a dense cache): the streams, rounds and acceptance counts
    of the JAX spec engine, and every proposal accepted."""
    cfg, jcfg = vlm["cfg"], vlm["jcfg"]
    got, rep = _streams(ServingEngine(cfg, vlm["params"], max_slots=2,
                                      max_len=64, device="cpu",
                                      draft=(cfg, vlm["params"]), spec_k=4),
                        vlm["prompts"])
    want, jrep = _streams(JaxEngine(jcfg, vlm["jparams"], max_slots=2,
                                    max_len=64, policy=PALLAS,
                                    draft=(jcfg, vlm["jparams"]), spec_k=4),
                          vlm["prompts"])
    assert got == want
    for key in ("spec_rounds", "spec_proposed", "spec_accepted",
                "decode_tokens"):
        assert rep[key] == jrep[key], key
    assert rep["spec_acceptance_rate"] == 1.0
