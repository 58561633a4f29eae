"""The port's roofline models and report (`repro_torch.roofline.analysis`)
against the JAX package's `roofline/analysis.py`, on the same integers.

Tolerance: exact. The byte models, the KV and SSM state models,
`kv_capacity_model`, `count_params` and `model_flops` are integer
arithmetic on shapes (model_flops a float of an integer product): each
tile-independent model gives the reference's number, and each one that
depends on a tile gives the reference's formula at the tile the port's
kernel runs (passed to the reference as its `cfg`). One difference by
design: `quant_gemm_savings` takes each kernel's own tile (the int8
kernel's plan on the quantized side), where the reference takes one tile
for both sides.
"""

import dataclasses
import json

import pytest

from repro.configs import base as jbase
from repro.configs import get_config as jax_get_config
from repro.core import blocking as jb
from repro.roofline import analysis as jan
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs import base
from repro_torch.core import blocking as b
from repro_torch.core import hw
from repro_torch.roofline import analysis as an
from repro_torch.roofline.counter import Costs

GEMMS = [(4, 1024, 3072), (256, 3072, 1024), (2048, 1024, 3072),
         (4096, 2048, 8192), (7, 300, 200)]


def _j(cfg):
    cls = {b.BlockConfig: jb.BlockConfig, b.FlashBlockConfig:
           jb.FlashBlockConfig, b.SSDBlockConfig: jb.SSDBlockConfig}[type(cfg)]
    return cls(**dataclasses.asdict(cfg))


def _numbers(d):
    return {k: v for k, v in d.items() if isinstance(v, (int, float))}


def test_shape_cells_are_the_references():
    assert [dataclasses.astuple(s) for s in base.SHAPES] == \
        [dataclasses.astuple(s) for s in jbase.SHAPES]
    assert base.get_shape("decode_32k") == base.ShapeCell(
        "decode_32k", "decode", 32_768, 128)
    with pytest.raises(KeyError):
        base.get_shape("nope")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_count_params_and_model_flops_are_the_references(name):
    cfg, jcfg = get_config(name), jax_get_config(name)
    assert an.count_params(cfg) == jan.count_params(jcfg)
    for cell, jcell in zip(base.SHAPES, jbase.SHAPES):
        for kind in ("train", "prefill", "decode"):
            assert an.model_flops(cfg, cell, kind=kind) == \
                jan.model_flops(jcfg, jcell, kind=kind), (cell.name, kind)


@pytest.mark.parametrize("m,k,n", GEMMS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_epilogue_and_gated_mlp_models_at_the_kernels_tiles(m, k, n, itemsize):
    cfg = _j(b.choose_block_config(m, n, k, itemsize))
    for ep in ("none", "bias", "bias_gelu", "residual"):
        for fused in (True, False):
            assert an.epilogue_traffic_bytes(m, n, k, itemsize, ep,
                                             fused=fused) == \
                jan.epilogue_traffic_bytes(m, n, k, itemsize, ep, cfg=cfg,
                                           fused=fused)
    d, f = k, n
    down = _j(b.choose_block_config(m, d, f, itemsize))
    for fused in (True, False):
        hidden = _j(b.choose_block_config(m, f, d, itemsize,
                                          n_rhs=2 if fused else 1))
        assert _numbers(an.gated_mlp_traffic(m, d, f, itemsize,
                                             fused=fused)) == \
            _numbers(jan.gated_mlp_traffic(m, d, f, itemsize, fused=fused,
                                           cfg_hidden=hidden, cfg_down=down))
    s = an.gated_mlp_savings(m, d, f, itemsize)
    assert s["fused_bytes"] == jan.gated_mlp_traffic(
        m, d, f, itemsize, fused=True, cfg_down=down, cfg_hidden=_j(
            b.choose_block_config(m, f, d, itemsize, n_rhs=2)))["total_bytes"]
    assert s["unfused_bytes"] == jan.gated_mlp_traffic(
        m, d, f, itemsize, fused=False, cfg_down=down, cfg_hidden=_j(
            b.choose_block_config(m, f, d, itemsize)))["total_bytes"]


@pytest.mark.parametrize("m,k,n", GEMMS)
def test_int8_models_at_the_kernels_tiles(m, k, n):
    full = _j(b.choose_block_config(m, n, k, 2))
    q = _j(b.kernel_block_config("matmul_q", m, n, k, 2))
    want_full = jan.quant_gemm_traffic(m, n, k, 2, quant=False, cfg=full)
    want_q = jan.quant_gemm_traffic(m, n, k, 2, quant=True, cfg=q)
    assert an.quant_gemm_traffic(m, n, k, 2, quant=False) == want_full
    assert an.quant_gemm_traffic(m, n, k, 2, quant=True) == want_q
    s = an.quant_gemm_savings(m, n, k, 2)
    assert (s["full_bytes"], s["quant_bytes"]) == (want_full, want_q)
    assert s["saved_frac"] == 1.0 - want_q / want_full
    d, f = k, n
    hidden = _j(b.choose_block_config(m, f, d, 2, n_rhs=2))
    want = (jb.gated_traffic_bytes(m, f, d, hidden, 2)
            + jan.quant_gemm_traffic(m, d, f, 2, quant=False,
                                     cfg=_j(b.choose_block_config(m, d, f))),
            2 * jan.quant_gemm_traffic(
                m, f, d, 2, quant=True,
                cfg=_j(b.kernel_block_config("matmul_q", m, f, d)))
            + jan.quant_gemm_traffic(
                m, d, f, 2, quant=True,
                cfg=_j(b.kernel_block_config("matmul_q", m, d, f))))
    got = an.dense_q_layer_savings(m, d, f, 2)
    assert (got["full_bytes"], got["quant_bytes"]) == want


@pytest.mark.parametrize("tq,tk,d", [(512, 512, 128), (1500, 1500, 64),
                                     (448, 1500, 64), (4096, 4096, 128)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_attention_savings_at_the_kernels_tiles(tq, tk, d, itemsize):
    fwd = b.choose_flash_config(tq, tk, d, itemsize)
    assert _numbers(an.attention_fwd_savings(tq, tk, d, itemsize)) == \
        _numbers(jan.attention_fwd_savings(tq, tk, d, itemsize, cfg=_j(fwd)))
    assert _numbers(an.attention_bwd_savings(tq, tk, d, itemsize)) == \
        _numbers(jan.attention_bwd_savings(tq, tk, d, itemsize,
                                           cfg=_j(b.FLASH_BWD_TILE)))
    dec = b.choose_decode_config(tk, d, itemsize)
    for pos in (0, 127, tk - 1):
        assert _numbers(an.decode_attention_savings(pos, tk, d, itemsize)) \
            == _numbers(jan.decode_attention_savings(pos, tk, d, itemsize,
                                                     cfg=_j(dec)))


@pytest.mark.parametrize("l,h,p,n,chunk", [(4096, 80, 64, 128, 256),
                                           (512, 64, 64, 64, 128)])
def test_ssd_savings_at_the_kernels_tile(l, h, p, n, chunk):
    cfg = b.choose_ssd_config(chunk, p, n, 4)
    got = an.ssd_savings(l, h, p, n, chunk, 4)
    assert _numbers(got) == _numbers(jan.ssd_savings(l, h, p, n, chunk, 4,
                                                     cfg=_j(cfg)))
    assert got["saved_frac"] >= 0.40        # the reference's bar


def test_kv_and_state_models_are_the_references():
    for pos in (0, 15, 255, 4095):
        for heads, d in ((4, 64), (8, 128)):
            for itemsize in (2, 4):
                for q in ("off", "int8"):
                    assert an.kv_decode_traffic_bytes(
                        pos, heads, d, itemsize, quant_kv=q) == \
                        jan.kv_decode_traffic_bytes(pos, heads, d, itemsize,
                                                    quant_kv=q)
                assert an.kv_quant_savings(pos, heads, d, itemsize) == \
                    jan.kv_quant_savings(pos, heads, d, itemsize)
    for heads, p, n in ((80, 64, 128), (64, 64, 64)):
        assert an.ssm_decode_state_bytes(heads, p, n) == \
            jan.ssm_decode_state_bytes(heads, p, n)
    kw = dict(max_len=64, page_size=16, heads=4, d=64, itemsize=4,
              prompt_len=40, shared_prefix_len=32, gen=8)
    for pool in (2 * 64 * 2048, 10 ** 6, 7 * 10 ** 7):
        for q in ("off", "int8"):
            assert an.kv_capacity_model(pool, quant_kv=q, **kw) == \
                jan.kv_capacity_model(pool, quant_kv=q, **kw)


def test_the_report_keeps_the_references_fields(tmp_path):
    assert [f.name for f in dataclasses.fields(an.RooflineReport)] == \
        [f.name for f in dataclasses.fields(jan.RooflineReport)]
    cfg = get_config("qwen3-0.6b")
    cell = base.ShapeCell("decode_s4", "decode", 512, 4)
    costs = Costs(flops=1e12, hbm_bytes=6.7e9)
    rep = an.build_report(cfg, cell, kind="decode", costs=costs)
    h = hw.H100
    assert rep.t_compute == 1e12 / h.peak_flops_bf16
    assert rep.t_memory == 6.7e9 / h.hbm_bw
    assert (rep.t_collective, rep.n_devices, rep.collectives, rep.bound,
            rep.memory_analysis) == (0.0, 1, {}, "memory", {})
    mf = 2.0 * an.count_params(cfg)[1] * 4
    assert rep.model_flops_total == mf
    assert rep.useful_ratio == mf / 1e12
    assert rep.mfu_roofline == mf / h.peak_flops_bf16 / rep.t_memory
    assert "replays of a CUDA graph are not counted" in rep.note
    costs.peak_bytes = 123
    assert an.build_report(cfg, cell, kind="decode", costs=costs,
                           note="x").memory_analysis == \
        {"max_memory_allocated": 123}
    path = tmp_path / "r.json"
    an.save_report(rep, str(path))
    assert json.loads(path.read_text()) == rep.to_json()
    assert "bound=memory" in rep.summary_line()
