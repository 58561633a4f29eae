"""Tile and traffic models of the port's kernels: the paper's shared-memory
sizing argument ("2 * 16 * 16 * 8 B = 4 KB <= 48 KB") and its reuse
argument in byte form, behind the modeled Table 2 and Fig 8, carried over
to the flash, decode, SSD, dual and int8-weight kernels. The port's copy
of the JAX package's `core/blocking.py`, with shared memory a block in
place of VMEM.

For the paper's cards the GEMM chooser and the models give the JAX
package's numbers (C2050 at 4096^2 f32: a 64x128x128 tile, 0.1334 s tiled
and 3.818 s naive), since it keeps the JAX chooser's (sublane, lane)
alignment. On the H100 each `choose_*` returns the tile the port's kernel
runs for the shape: the GEMM plans of `kernels.matmul` (`tile_plan`,
`f32_tile_plan`, `q_tile_plan`, `gated_tile_plan`, which serve a set
tuning cache's winner first), the flash kernels' 64-row query tiles, the
decode kernels' splits of 64 keys and the SSD kernel's whole chunk (its
jobs are 64-row tiles of it). The modeled Table 2 takes `KERNEL_TILE`,
the f32 GEMM's wide tile at 4096^2.

Where a model does not depend on the tile it is the reference's, term
for term. The models count device-memory bytes and are blind to the L2,
as the reference's are. `l2_traffic_bytes` applies the chip's L2 to a
GEMM model's bytes: a re-read of an A or B panel costs device memory
only where one wave of blocks' panels (`wave_panel_bytes`) does not fit
in the L2.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import hw


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    bm: int
    bn: int
    bk: int

    def smem_bytes(self, itemsize: int) -> int:
        """Working set of the tiled kernel: the A and B tiles
        (double-buffered) and the f32 accumulator."""
        tiles = (self.bm * self.bk + self.bk * self.bn) * itemsize * 2
        return tiles + self.bm * self.bn * 4


#: The tile of the port's tiled f32 CUDA GEMM at the paper's size
#: (csrc/matmul.cu WB x WB, WBK; `kernels.matmul.f32_tile_plan`).
KERNEL_TILE = BlockConfig(128, 128, 16)


def _padded(cols: int) -> int:
    """Row length (elements) of a shared bf16 tile of `cols` columns
    (`csrc/mma.cuh` `padded`)."""
    c8 = (cols + 7) // 8 * 8
    return c8 if (cols + 7) // 8 % 2 == 1 else c8 + 8


@dataclasses.dataclass(frozen=True)
class FlashBlockConfig:
    """The tile of an attention kernel: bq query rows a block, bk keys a
    step (bq = 1: the decode kernels, bk keys a split)."""
    bq: int
    bk: int

    def smem_bytes(self, d: int, itemsize: int) -> int:
        """Shared memory a block holds (`csrc/flash_attention.cu`,
        `csrc/flash_decode.cu`): the bf16 forward its query tile and a
        ring of two K and two V tiles at the padded row of 64 or 128
        columns (`tc_fwd_smem`); the f32 forward its query and K tiles at
        129 floats a row, its V tile and the score tile (`FWD_SMEM`); a
        decode split its K and V rows at a 16-byte-chunk row and the
        staged query, probabilities, row offsets and scales."""
        if self.bq == 1:
            row = ((d * itemsize + 15) // 16 | 1) * 16
            return (2 * self.bk * row + 2 * 64 * (8 + 4)
                    + 4 * 256 * 4 + 4 * 64 * 4)
        if itemsize == 2:
            return (self.bq + 4 * self.bk) * _padded(64 if d <= 64 else 128) * 2
        ld = 128 + 1
        return (self.bq * ld + self.bk * ld + self.bk * 128
                + self.bq * (self.bk + 1)) * 4


#: The flash forward's tile by itemsize: the bf16 tensor-core kernel's
#: 64 x 64, the f32 FMA kernel's 64 queries against 32 keys a step.
FLASH_TILES = {2: FlashBlockConfig(64, 64), 4: FlashBlockConfig(64, 32)}
#: The two-sweep backward's tile, in either dtype.
FLASH_BWD_TILE = FlashBlockConfig(64, 64)
#: Keys of a decode split (`kernels.flash_attention.DECODE_SPLIT`).
DECODE_SPLIT = 64


def choose_flash_config(
    tq: int,
    tk: int,
    d: int,
    itemsize: int = 2,
    chip: hw.ChipSpec = hw.DEFAULT_CHIP,
) -> FlashBlockConfig:
    """The flash forward's tile for (tq, tk, d): 64 query rows a block and
    64 keys a step in bf16 (32 in f32), whatever the lengths (a ragged
    edge is masked). The tuning space holds only this one."""
    return FLASH_TILES[4 if itemsize == 4 else 2]


def choose_decode_config(
    tk: int,
    d: int,
    itemsize: int = 2,
    chip: hw.ChipSpec = hw.DEFAULT_CHIP,
) -> FlashBlockConfig:
    """The decode kernels' tile: one query row, splits of 64 keys at fixed
    positions, each summed alone and then merged; only the splits that
    meet a slot's keys run (`kernels.flash_attention.decode_splits`)."""
    return FlashBlockConfig(bq=1, bk=DECODE_SPLIT)


@dataclasses.dataclass(frozen=True)
class SSDBlockConfig:
    """Tile sizes for the SSD intra-chunk kernel: `q` is the execution
    chunk along time (any divisor of the model chunk computes the same
    function: SSD chunking is exact), `bp` tiles the head dim."""
    q: int
    bp: int

    def smem_bytes(self, n: int, itemsize: int, heads: int = 1) -> int:
        """Shared memory a block of `csrc/ssd.cu` holds for `heads` heads of
        one group (2 where a group's heads pair up and P <= 64): each
        head's running sum of a over the chunk (rounded up to 64 rows), a
        row job's (64, N) C tile, and a two-stage ring of 16-key steps,
        each one B tile and the heads' x tiles (`make_layout`,
        `smem_bytes`)."""
        per_word = 4 // itemsize

        def ld(cols, rem):
            words = ((cols + per_word - 1) // per_word + 3) // 4 * 4
            words += ((rem - words % 32) % 32 + 32) % 32
            return words * per_word
        n8 = (n + 7) // 8 * 8
        pw = 32 if self.bp <= 32 else 64 if self.bp <= 64 else 128
        ldc = ld(n8, 8 if itemsize == 4 else 4)
        lds, ldx = ld(64, 4), ld(pw, 4)
        qp = (self.q + 63) // 64 * 64
        ring = 16 * max(ldc, lds) + heads * 16 * ldx
        return heads * qp * 4 + (64 * ldc + 2 * ring) * itemsize


def choose_ssd_config(
    chunk: int,
    p: int,
    n: int,
    itemsize: int = 4,
    chip: hw.ChipSpec = hw.DEFAULT_CHIP,
) -> SSDBlockConfig:
    """The SSD kernel's tile: the model's whole chunk and head dim (its
    jobs are the chunk's 64-row tiles of y_diag and of the state, each
    staging 16 keys a step), refused where a block's shared memory would
    not fit the chip's."""
    cfg = SSDBlockConfig(q=chunk, bp=p)
    if cfg.smem_bytes(n, itemsize) > chip.smem_bytes:
        raise ValueError(f"the SSD kernel at chunk {chunk}, P {p}, N {n} "
                         f"needs {cfg.smem_bytes(n, itemsize)} bytes of "
                         f"shared memory a block; {chip.name} has "
                         f"{chip.smem_bytes}")
    return cfg


def ssd_traffic_bytes(
    l: int, h: int, p: int, n: int, cfg: SSDBlockConfig, itemsize: int
) -> int:
    """Bytes the SSD composition moves for one (batch, layer): the kernel
    streams x/a and the head-broadcast b/c once per head-tile column
    (`ceil(p/bp)`), writes the chunk-diagonal y and the per-chunk states
    in f32, and the inter-chunk pass reads the states + y_diag + c and
    writes y. The (q, q) decay mask and CB score matrices stay in shared
    memory and never exist in device memory."""
    nc = math.ceil(l / cfg.q)
    n_p = math.ceil(p / cfg.bp)
    x_bytes = l * h * p * itemsize
    a_bytes = l * h * itemsize * n_p
    bc_bytes = 2 * l * h * n * itemsize * n_p
    y_diag = l * h * p * 4                      # kernel out, f32
    states = nc * h * n * p * 4                 # kernel out, f32
    # inter-chunk pass: read states + y_diag + c, write y
    inter = states + y_diag + l * h * n * itemsize + l * h * p * itemsize
    return x_bytes + a_bytes + bc_bytes + y_diag + states + inter


def ssd_unfused_traffic_bytes(
    l: int, h: int, p: int, n: int, chunk: int, itemsize: int
) -> int:
    """The chunked composition without the kernel: the per-chunk (Q, Q)
    f32 decay mask is written + read and the CB score matrix is written +
    read twice (once masked for y_diag, once raw): four quadratic f32
    trips per (chunk, head), `4 * Q*Q * 4` bytes, plus the linear operand
    streams, the f32 decay vectors and the per-chunk state round trip."""
    nc = math.ceil(l / chunk)
    operands = (l * h * p + l * h + 2 * l * h * n) * itemsize
    s_bytes = nc * h * 4 * chunk * chunk * 4    # ldec + cb round trips
    decays = 3 * l * h * 4                      # a_cum, decay_to_end, ...
    states = 2 * nc * h * n * p * 4             # written, re-read by scan
    y_bytes = 2 * l * h * p * 4 + l * h * p * itemsize  # y_diag+y_off+y
    return operands + s_bytes + decays + states + y_bytes


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _round_down_pow2_mult(x: int, m: int) -> int:
    """Largest multiple of m that is <= x (at least m)."""
    return max(m, (x // m) * m)


def kernel_block_config(op: str, m: int, n: int, k: int,
                        itemsize: int = 2) -> BlockConfig:
    """The tile the port's GEMM kernel `op` ("matmul", "gated" or
    "matmul_q") runs for an (m, k) x (k, n) product of `itemsize`
    activations: its plan in `kernels.matmul`, a set tuning cache's winner
    first."""
    from repro_torch.kernels import matmul as _mm
    if itemsize == 4:
        plan = _mm.f32_tile_plan(m, k, n) if op == "matmul" else \
            _mm.static_plan(op, "float32", m, k, n)
    else:
        plan = {"matmul": lambda: _mm.tile_plan(m, k, n, False, False),
                "gated": lambda: _mm.gated_tile_plan(m, k, n),
                "matmul_q": lambda: _mm.q_tile_plan(m, k, n)}[op]()
    return BlockConfig(plan.bm, plan.bn, plan.bk)


def choose_block_config(
    m: int,
    n: int,
    k: int,
    itemsize: int = 2,
    chip: hw.ChipSpec = hw.DEFAULT_CHIP,
    n_rhs: int = 1,
) -> BlockConfig:
    """Pick (bm, bn, bk) for an (m, k) x (k, n) GEMM. On a chip that runs
    the port's kernels (`ChipSpec.runs_port_kernels`: sm_90 and up) it is
    the tile the kernel runs (`kernel_block_config`; n_rhs=2: the dual
    GEMM's). On the paper's cards it is the JAX chooser's: start from
    512x512x2048-ish aligned tiles, clamp to the problem, then shrink (bk
    first, down to 512, then the larger of bm and bn) until the
    double-buffered working set fits half the chip's shared memory."""
    if chip.runs_port_kernels:
        return kernel_block_config("gated" if n_rhs == 2 else "matmul",
                                   m, n, k, itemsize)
    budget = chip.smem_bytes // 2
    lane = chip.lane
    sub = chip.sublane(itemsize)

    bm = min(_round_up(m, sub), 512)
    bn = min(_round_up(n, lane), 512)
    bk = min(_round_up(k, lane), 2048)
    bm = _round_down_pow2_mult(bm, sub)
    bn = _round_down_pow2_mult(bn, lane)
    bk = _round_down_pow2_mult(bk, lane)

    cfg = BlockConfig(bm, bn, bk)
    while cfg.smem_bytes(itemsize) > budget:
        if cfg.bk > 512:
            cfg = BlockConfig(cfg.bm, cfg.bn, _round_down_pow2_mult(cfg.bk // 2, lane))
        elif cfg.bm >= cfg.bn and cfg.bm > sub:
            cfg = BlockConfig(_round_down_pow2_mult(cfg.bm // 2, sub), cfg.bn, cfg.bk)
        elif cfg.bn > lane:
            cfg = BlockConfig(cfg.bm, _round_down_pow2_mult(cfg.bn // 2, lane), cfg.bk)
        elif cfg.bk > lane:
            cfg = BlockConfig(cfg.bm, cfg.bn, _round_down_pow2_mult(cfg.bk // 2, lane))
        else:
            break  # minimum tile; give up shrinking
    return cfg


def wave_panel_bytes(m: int, n: int, k: int, cfg: BlockConfig,
                     a_itemsize: int, b_itemsize: int,
                     chip: hw.ChipSpec, n_rhs: int = 1) -> int:
    """Bytes of the A and B panels (bm x K, K x bn; n_rhs B operands)
    that one wave of blocks reads: one block an SM, the grid issued in
    order with the N blocks of a row fastest, so a wave spans
    ceil(wave / n_n) A panels and min(wave, n_n) B panels."""
    n_m, n_n = math.ceil(m / cfg.bm), math.ceil(n / cfg.bn)
    wave = min(n_m * n_n, chip.sm_count)
    rows, cols = math.ceil(wave / n_n), min(wave, n_n)
    return (rows * cfg.bm * k * a_itemsize
            + n_rhs * cols * k * cfg.bn * b_itemsize)


def l2_traffic_bytes(model_bytes: int, compulsory_bytes: int,
                     panel_bytes: int, chip: hw.ChipSpec) -> int:
    """A tiled model's bytes with the chip's L2: the re-reads the model
    counts come from the L2, not device memory, where one wave's panels
    fit in it (`panel_bytes` <= l2_bytes); never below the compulsory
    bytes (each operand and output once)."""
    if panel_bytes <= chip.l2_bytes:
        return compulsory_bytes
    return max(model_bytes, compulsory_bytes)


def hbm_traffic_bytes(
    m: int, n: int, k: int, cfg: BlockConfig, itemsize: int
) -> int:
    """Bytes the tiled kernel moves from device memory (the Fig-8 model):
    A is streamed once per N-block column, B once per M-block row, C is
    written once. Blocking divides the traffic by the block edge."""
    n_m = math.ceil(m / cfg.bm)
    n_n = math.ceil(n / cfg.bn)
    a_bytes = m * k * itemsize * n_n
    b_bytes = k * n * itemsize * n_m
    c_bytes = m * n * itemsize
    return a_bytes + b_bytes + c_bytes


def gated_traffic_bytes(
    m: int, n: int, k: int, cfg: BlockConfig, itemsize: int
) -> int:
    """Bytes the fused dual-GEMM (gated) kernel moves: one A stream feeds
    BOTH weight operands (A read once per N-block column), each of the two
    B operands is read once per M-block row, and only the gated product is
    written; the two (m, n) intermediates never touch device memory."""
    n_m = math.ceil(m / cfg.bm)
    n_n = math.ceil(n / cfg.bn)
    a_bytes = m * k * itemsize * n_n
    b_bytes = 2 * k * n * itemsize * n_m
    c_bytes = m * n * itemsize
    return a_bytes + b_bytes + c_bytes


def quant_traffic_bytes(
    m: int, n: int, k: int, cfg: BlockConfig, itemsize: int,
    w_itemsize: int = 1, scale_itemsize: int = 4,
) -> int:
    """Bytes the int8-weight tiled kernel moves: the reuse structure of
    hbm_traffic_bytes, but B stored at `w_itemsize` (1 for int8) and a
    (1, N) per-channel scale row riding along once per M-block row; A, C
    and the arithmetic stay full precision."""
    n_m = math.ceil(m / cfg.bm)
    n_n = math.ceil(n / cfg.bn)
    a_bytes = m * k * itemsize * n_n
    b_bytes = k * n * w_itemsize * n_m
    s_bytes = n * scale_itemsize * n_m
    c_bytes = m * n * itemsize
    return a_bytes + b_bytes + s_bytes + c_bytes


def naive_traffic_bytes(m: int, n: int, k: int, itemsize: int) -> int:
    """Traffic model of the naive kernel (paper Listing 3): each output
    element streams a full row of A and column of B with no reuse, A read
    n times and B read m times."""
    return (m * k * n + k * n * m + m * n) * itemsize


def flash_traffic_bytes(
    tq: int, tk: int, d: int, cfg: FlashBlockConfig, itemsize: int
) -> int:
    """Bytes the fused flash forward moves, per (batch x head) slice:
    multiply by B*H for a layer. Each Q tile stays resident while its
    block streams the keys: Q and O move once, K and V once per Q block
    row. The S and P matrices never exist in device memory: the term this
    model conspicuously lacks."""
    n_q = math.ceil(tq / cfg.bq)
    q_bytes = tq * d * itemsize
    kv_bytes = 2 * tk * d * itemsize * n_q
    o_bytes = tq * d * itemsize
    return q_bytes + kv_bytes + o_bytes


def flash_unfused_traffic_bytes(tq: int, tk: int, d: int,
                                itemsize: int) -> int:
    """The materialised-softmax baseline: one pass writes S = QK^T, a
    second normalises it to P, a third contracts with V. Operands move
    once, but the (tq, tk) score matrix makes four f32 trips: S written +
    read, P written + read."""
    qkv_bytes = (tq + 2 * tk) * d * itemsize
    s_bytes = 4 * tq * tk * 4
    o_bytes = tq * d * itemsize
    return qkv_bytes + s_bytes + o_bytes


def decode_traffic_bytes(pos: int, tk: int, d: int, cfg: FlashBlockConfig,
                         itemsize: int) -> int:
    """Fused decode-step traffic per (batch x head): the single query row
    and output row bracket a K/V stream that covers only the splits that
    meet the valid cache prefix, so a depth-4096 cache at pos=127 moves
    ceil(128/bk)*bk rows, not 4096."""
    n_blocks = math.ceil((pos + 1) / cfg.bk)
    kv_bytes = 2 * n_blocks * cfg.bk * d * itemsize
    return kv_bytes + 2 * d * itemsize


def decode_unfused_traffic_bytes(pos: int, tk: int, d: int,
                                 itemsize: int) -> int:
    """The masked-dense decode baseline (attention over the whole cache
    buffer): padding cannot be skipped because the mask is data, so all
    tk cache rows stream, plus the (1, tk) score row's f32 round trips.
    `pos` is accepted for signature symmetry: the baseline's traffic does
    not depend on it, which is exactly the problem."""
    del pos
    kv_bytes = 2 * tk * d * itemsize
    s_bytes = 4 * tk * 4
    return kv_bytes + s_bytes + 2 * d * itemsize


def flash_bwd_traffic_bytes(
    tq: int, tk: int, d: int, cfg: FlashBlockConfig, itemsize: int
) -> int:
    """Recompute-style flash backward, per (batch x head): two sweeps,
    neither of which ever reads or writes the (tq, tk) matrices.

    Sweep 1 (dK/dV, kv-outer grid): K/V move once, the q-side streams
    (q, do + the f32 lse/delta rows) re-read per kv block row, dK/dV
    written once in f32. Sweep 2 (dQ, q-outer grid): mirror image.
    delta = rowsum(do * o) is a pre-pass: o and do read once more."""
    n_q = math.ceil(tq / cfg.bq)
    n_k = math.ceil(tk / cfg.bk)
    rows = 2 * tq * 4                          # lse + delta, f32
    q_stream = 2 * tq * d * itemsize + rows    # q + do + rows
    sweep1 = 2 * tk * d * itemsize + n_k * q_stream + 2 * tk * d * 4
    sweep2 = q_stream + n_q * 2 * tk * d * itemsize + tq * d * 4
    delta_pass = 2 * tq * d * itemsize + tq * 4
    return sweep1 + sweep2 + delta_pass


def flash_bwd_stored_traffic_bytes(tq: int, tk: int, d: int,
                                   itemsize: int) -> int:
    """Stored-S attention backward: the classic formulation keeps the
    (tq, tk) probability matrix from the forward and replays it. P is read
    twice (dV and dS), dS is written then re-read for dQ/dK: four f32
    trips of the quadratic matrix, dwarfing the linear operands."""
    operands = (3 * tq + 2 * tk) * d * itemsize   # q, do, o, k, v
    s_bytes = 4 * tq * tk * 4
    outs = (tq + 2 * tk) * d * 4                  # dq, dk, dv in f32
    return operands + s_bytes + outs + 2 * tq * 4


def gemm_time_model(
    m: int,
    n: int,
    k: int,
    itemsize: int,
    cfg: BlockConfig | None,
    chip: hw.ChipSpec = hw.DEFAULT_CHIP,
) -> dict:
    """Roofline time of one GEMM on `chip`: cfg=None is the naive traffic
    model. Returns both terms and which one bounds it."""
    flops = 2.0 * m * n * k
    if cfg is None:
        traffic = naive_traffic_bytes(m, n, k, itemsize)
    else:
        traffic = hbm_traffic_bytes(m, n, k, cfg, itemsize)
    t_compute = flops / chip.peak_flops(itemsize)
    t_memory = traffic / chip.hbm_bw
    return {
        "flops": flops,
        "bytes": traffic,
        "t_compute": t_compute,
        "t_memory": t_memory,
        "t_total": max(t_compute, t_memory),
        "bound": "compute" if t_compute >= t_memory else "memory",
        "arithmetic_intensity": flops / traffic,
    }
