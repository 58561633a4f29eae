"""The port's tile and traffic models (`repro_torch.core.blocking`) against
the JAX package's `core/blocking.py`, on the same integers.

Tolerance: exact. Every model is integer arithmetic on shapes, so each
tile-independent model must give the reference's integer, and each
tile-dependent one the reference's formula evaluated at the tile the
port's kernel runs (the reference's config built from the port's).
The H100 L2 model, which the reference lacks, is held to its own rule.
"""

import dataclasses

import pytest

from repro.core import blocking as jb
from repro_torch.core import blocking as b
from repro_torch.core import hw
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as tmm
from repro_torch.tuning import cache as tcache
from repro_torch.tuning import space

GRID = [(1, 64, 64), (7, 300, 64), (128, 128, 128), (500, 512, 128),
        (4096, 4096, 64), (1500, 1500, 64)]
SSD_GRID = [(256, 8, 64, 128, 64), (4096, 80, 64, 128, 256),
            (200, 2, 16, 8, 200), (512, 64, 64, 64, 128)]
GEMMS = [(4, 1024, 3072), (256, 3072, 1024), (2048, 1024, 3072),
         (2048, 8192, 2048), (4096, 4096, 4096), (7, 300, 200)]


def _j(cfg):
    """The reference's config of the port's tile."""
    cls = {b.BlockConfig: jb.BlockConfig, b.FlashBlockConfig:
           jb.FlashBlockConfig, b.SSDBlockConfig: jb.SSDBlockConfig}[type(cfg)]
    return cls(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("tq,tk,d", GRID)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_tile_independent_attention_models_are_the_references(tq, tk, d,
                                                              itemsize):
    assert b.flash_unfused_traffic_bytes(tq, tk, d, itemsize) == \
        jb.flash_unfused_traffic_bytes(tq, tk, d, itemsize)
    assert b.flash_bwd_stored_traffic_bytes(tq, tk, d, itemsize) == \
        jb.flash_bwd_stored_traffic_bytes(tq, tk, d, itemsize)
    for pos in (0, tk // 2, tk - 1):
        assert b.decode_unfused_traffic_bytes(pos, tk, d, itemsize) == \
            jb.decode_unfused_traffic_bytes(pos, tk, d, itemsize)


@pytest.mark.parametrize("tq,tk,d", GRID)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_attention_models_at_the_ports_tiles(tq, tk, d, itemsize):
    fwd = b.choose_flash_config(tq, tk, d, itemsize)
    assert b.flash_traffic_bytes(tq, tk, d, fwd, itemsize) == \
        jb.flash_traffic_bytes(tq, tk, d, _j(fwd), itemsize)
    bwd = b.FLASH_BWD_TILE
    assert b.flash_bwd_traffic_bytes(tq, tk, d, bwd, itemsize) == \
        jb.flash_bwd_traffic_bytes(tq, tk, d, _j(bwd), itemsize)
    dec = b.choose_decode_config(tk, d, itemsize)
    for pos in (0, 63, 64, tk - 1):
        assert b.decode_traffic_bytes(pos, tk, d, dec, itemsize) == \
            jb.decode_traffic_bytes(pos, tk, d, _j(dec), itemsize)


@pytest.mark.parametrize("l,h,p,n,chunk", SSD_GRID)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_ssd_models(l, h, p, n, chunk, itemsize):
    assert b.ssd_unfused_traffic_bytes(l, h, p, n, chunk, itemsize) == \
        jb.ssd_unfused_traffic_bytes(l, h, p, n, chunk, itemsize)
    cfg = b.choose_ssd_config(chunk, p, n, itemsize)
    assert cfg == b.SSDBlockConfig(chunk, p)
    assert b.ssd_traffic_bytes(l, h, p, n, cfg, itemsize) == \
        jb.ssd_traffic_bytes(l, h, p, n, _j(cfg), itemsize)


@pytest.mark.parametrize("m,k,n", GEMMS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_gemm_models_at_the_kernels_tiles(m, k, n, itemsize):
    cfg = b.choose_block_config(m, n, k, itemsize)
    plan = tmm.tile_plan(m, k, n, False, False) if itemsize == 2 \
        else tmm.f32_tile_plan(m, k, n)
    assert cfg == b.BlockConfig(plan.bm, plan.bn, plan.bk)
    assert b.hbm_traffic_bytes(m, n, k, cfg, itemsize) == \
        jb.hbm_traffic_bytes(m, n, k, _j(cfg), itemsize)
    gated = b.choose_block_config(m, n, k, itemsize, n_rhs=2)
    if itemsize == 2:
        g = tmm.gated_tile_plan(m, k, n)
        assert gated == b.BlockConfig(g.bm, g.bn, g.bk)
    assert b.gated_traffic_bytes(m, n, k, gated, itemsize) == \
        jb.gated_traffic_bytes(m, n, k, _j(gated), itemsize)
    q = b.kernel_block_config("matmul_q", m, n, k, itemsize)
    if itemsize == 2:
        qp = tmm.q_tile_plan(m, k, n)
        assert q == b.BlockConfig(qp.bm, qp.bn, qp.bk)
    assert b.quant_traffic_bytes(m, n, k, q, itemsize) == \
        jb.quant_traffic_bytes(m, n, k, _j(q), itemsize)
    assert b.naive_traffic_bytes(m, n, k, itemsize) == \
        jb.naive_traffic_bytes(m, n, k, itemsize)


def test_a_set_tuning_cache_moves_the_chosen_tile(tmp_path):
    """The chooser reads the kernels' plans, so a set cache's winner is
    the tile it models."""
    c = tcache.TuningCache(str(tmp_path / "c.json"))
    c.put_matmul(4, 1024, 1024, "bfloat16", tmm._WIDE192)
    c.put_gated(2048, 3072, 1024, "bfloat16", tmm._GATED_ROWS16)
    static = b.choose_block_config(4, 1024, 1024)
    with tcache.tuned(c):
        assert b.choose_block_config(4, 1024, 1024) == b.BlockConfig(
            128, 192, 64)
        assert b.choose_block_config(2048, 3072, 1024, n_rhs=2) == \
            b.BlockConfig(16, 16, 128)
    assert b.choose_block_config(4, 1024, 1024) == static == \
        b.BlockConfig(16, 8, 256)


def test_the_choosers_are_the_kernels_and_the_tuning_spaces():
    assert b.DECODE_SPLIT == fa.DECODE_SPLIT
    for dtype, itemsize in (("bfloat16", 2), ("float32", 4)):
        assert space.flash_candidates(512, 512, 128, dtype) == \
            [b.choose_flash_config(512, 512, 128, itemsize)]
        assert space.flash_decode_candidates(2048, 128, dtype) == \
            [b.choose_decode_config(2048, 128, itemsize)]
    assert space.flash_bwd_candidates(512, 512, 128) == [b.FLASH_BWD_TILE]
    assert space.ssd_candidates(256, 64, 128) == \
        [b.choose_ssd_config(256, 64, 128)]
    assert tcache.FlashBlockConfig is b.FlashBlockConfig
    assert tcache.SSDBlockConfig is b.SSDBlockConfig
    # the paper's cards keep the JAX chooser's answer
    assert b.choose_block_config(4096, 4096, 4096, 4, chip=hw.TESLA_C2050) \
        == b.BlockConfig(64, 128, 128)
    # a Hopper spec other than hw.H100 itself gets the kernels' tile: the
    # chooser reads the compute capability, not the object
    other = dataclasses.replace(hw.H100, name="h100-pcie", hbm_bw=2.0e12)
    assert b.choose_block_config(4, 1024, 3072, chip=other) == \
        b.choose_block_config(4, 1024, 3072) == \
        b.kernel_block_config("matmul", 4, 1024, 3072)
    assert not hw.TESLA_C2050.runs_port_kernels


@pytest.mark.parametrize("d", [64, 128])
def test_shared_memory_of_the_ports_tiles_fits_the_card(d):
    """The kernels' own shared-memory sums (`csrc/flash_attention.cu`
    tc_fwd_smem and FWD_SMEM, `csrc/flash_decode.cu`, `csrc/ssd.cu`
    smem_bytes), each within the 227 KB a block may ask for."""
    chip = hw.H100
    pd = 72 if d == 64 else 136                 # csrc/mma.cuh padded(DP)
    assert b.FLASH_TILES[2].smem_bytes(d, 2) == (64 + 4 * 64) * pd * 2
    assert b.FLASH_TILES[4].smem_bytes(d, 4) == \
        (64 * 129 + 32 * 129 + 32 * 128 + 64 * 33) * 4
    row = ((d * 2 + 15) // 16 | 1) * 16
    assert b.choose_decode_config(2048, d).smem_bytes(d, 2) == \
        2 * 64 * row + 6656
    for itemsize in (2, 4):
        for cfg in (b.choose_flash_config(512, 512, d, itemsize),
                    b.choose_decode_config(2048, d, itemsize)):
            assert 0 < cfg.smem_bytes(d, itemsize) <= chip.smem_bytes
    # mamba2-2.7b's chunk 256, P 64, N 128 and zamba2's 128/64/64,
    # one head and a head pair a block
    for q, p, n in ((256, 64, 128), (128, 64, 64)):
        cfg = b.choose_ssd_config(q, p, n)
        for itemsize in (2, 4):
            one = cfg.smem_bytes(n, itemsize)
            two = cfg.smem_bytes(n, itemsize, heads=2)
            assert 0 < one < two <= chip.smem_bytes, (q, p, n, one, two)


def test_ssd_shared_memory_is_the_kernels_layout():
    """`csrc/ssd.cu` at Q 256, N 128, P 64 in f32: ldc = ldb = 136
    (tile_ld(128, 8)), lds = 68 (tile_ld(64, 4)), ldx = 68, qp = 256;
    HS qp 4 + (64 ldc + 2 (16 max(ldb, lds) + HS 16 ldx)) 4."""
    cfg = b.SSDBlockConfig(256, 64)
    assert cfg.smem_bytes(128, 4) == 256 * 4 + (64 * 136 + 2 * (
        16 * 136 + 16 * 68)) * 4
    assert cfg.smem_bytes(128, 4, heads=2) == 2 * 256 * 4 + (64 * 136 + 2 * (
        16 * 136 + 2 * 16 * 68)) * 4
    with pytest.raises(ValueError, match="shared memory"):
        b.choose_ssd_config(256, 64, 1024)


def test_the_h100s_data_sheet_fields():
    h = hw.H100
    assert (h.hbm_bytes, h.l2_bytes, h.peak_flops_tf32, h.sm_count) == \
        (80 * 10 ** 9, 50 * 1024 ** 2, 495e12, 132)
    assert h.nvlink_bw * 2 * h.nvlink_links == 900e9


def test_the_l2_model():
    """Re-reads of a panel cost device memory only where one wave's
    panels overflow the L2; never below the compulsory bytes."""
    chip = hw.H100
    # 2048 x 3072 x 1024 bf16 at 128 x 128: a wave of 132 blocks spans
    # 6 A panels and 24 B panels, 7.5 MB: the L2 serves every re-read
    m, n, k = 2048, 3072, 1024
    cfg = b.choose_block_config(m, n, k)

    def with_l2(k, n_rhs=1, w_itemsize=2, scale_bytes=0):
        model = {1: b.hbm_traffic_bytes(m, n, k, cfg, 2),
                 2: b.gated_traffic_bytes(m, n, k, cfg, 2)}[n_rhs] \
            if w_itemsize == 2 else b.quant_traffic_bytes(m, n, k, cfg, 2)
        compulsory = (m * k + m * n) * 2 + n_rhs * k * n * w_itemsize \
            + scale_bytes
        panels = b.wave_panel_bytes(m, n, k, cfg, 2, w_itemsize, chip, n_rhs)
        return model, b.l2_traffic_bytes(model, compulsory, panels, chip), \
            compulsory
    assert b.wave_panel_bytes(m, n, k, cfg, 2, 2, chip) == \
        (6 * 128 + 24 * 128) * 1024 * 2
    blind, got, compulsory = with_l2(k)
    assert got == compulsory == (m * k + k * n + m * n) * 2 < blind
    # K = 65536: 6 + 24 panels of 16 MB and 4 MB each... overflow: the
    # reference's model stands
    assert b.wave_panel_bytes(m, n, 65536, cfg, 2, 2, chip) > chip.l2_bytes
    blind, got, _ = with_l2(65536)
    assert got == blind
    for kw in (dict(n_rhs=2), dict(w_itemsize=1, scale_bytes=n * 4)):
        for kk in (1024, 65536):
            blind, got, compulsory = with_l2(kk, **kw)
            assert compulsory <= got <= blind
            assert (got == compulsory) == (kk == 1024)
    assert b.l2_traffic_bytes(10, 30, 1, chip) == 30    # never below
    assert b.l2_traffic_bytes(50, 30, chip.l2_bytes + 1, chip) == 50
