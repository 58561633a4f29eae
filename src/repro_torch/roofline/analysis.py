"""Roofline terms of a step, and the traffic models they rest on.

    compute term    = FLOPs / peak FLOP/s (bf16)
    memory term     = device-memory bytes / HBM bandwidth
    collective term = NVLink bytes / link bandwidth (0 on one card)

The port's copy of the JAX package's `roofline/analysis.py`. The FLOPs
and bytes come from `roofline.counter`, which counts a step while it
runs (the counterpart of the reference's HLO analyzer). MODEL_FLOPS is
the 6·N·D / 2·N·D convention (N = active params for MoE), so the
MODEL_FLOPS / counted-FLOPs ratio exposes remat and redundant compute.

The byte models are the reference's, evaluated at the tiles the port's
kernels run (`core.blocking`'s `choose_*`). The charges at the end are
what each op of `kernels.ops` costs under the counter: its compulsory
bytes (each operand and output once) and its FLOPs, from its operands'
shapes and dtypes alone, so a step counts the same on the CPU and on the
card.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import NamedTuple

import torch

from repro_torch.core import blocking, hw


def _leaf_counts(cfg) -> tuple[int, int]:
    """(params, expert-bank params) of `cfg`, its params made under a
    FakeTensorMode: shapes only, nothing allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models import model as M
    with FakeTensorMode():
        params = M.init_params(cfg, torch.Generator(), device="cpu")
    total = experts = 0

    def walk(tree, path):
        nonlocal total, experts
        for key, v in tree.items():
            p = f"{path}/{key}" if path else key
            if isinstance(v, dict):
                walk(v, p)
                continue
            total += v.numel()
            if "moe/w_" in p:
                experts += v.numel()
    walk(params, "")
    return total, experts


@functools.lru_cache(maxsize=None)
def count_params(cfg) -> tuple[int, int]:
    """(total, active) parameter counts, allocating nothing. A MoE's
    expert banks (the "moe/w_*" leaves) count top_k / n_experts of their
    size toward the active count. Its params are affine in n_experts (the
    banks and the router grow one expert's worth an expert), so a MoE is
    made at top_k and top_k + 1 experts and extrapolated: the full banks,
    one matrix at a time, are 13,440 matrices for arctic-480b. Cached by
    config (a frozen dataclass)."""
    moe = cfg.moe
    if moe is not None and moe.n_experts > moe.top_k + 1:
        e0 = moe.top_k
        (t0, x0), (t1, x1) = (_leaf_counts(dataclasses.replace(
            cfg, moe=dataclasses.replace(moe, n_experts=e)))
            for e in (e0, e0 + 1))
        grow = moe.n_experts - e0
        total, expert_total = t0 + grow * (t1 - t0), x0 + grow * (x1 - x0)
    else:
        total, expert_total = _leaf_counts(cfg)
    active = total
    if moe is not None and expert_total:
        frac = moe.top_k / moe.n_experts
        active = total - expert_total + int(expert_total * frac)
    return total, active


def model_flops(cfg, cell, *, kind: str) -> float:
    """6·N·D (train) / 2·N·D (prefill) / 2·N·B (one decode step),
    N = active params (MoE), D = tokens processed. Attention FLOPs are
    excluded by convention."""
    _, active = count_params(cfg)
    if kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * active * tokens
    if kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * active * tokens
    return 2.0 * active * cell.global_batch         # decode: one token/seq


# ----------------------------------------------------------------------
# Fused-kernel device-memory accounting, from the traffic models of
# core.blocking at the port's tiles.
# ----------------------------------------------------------------------

def epilogue_traffic_bytes(m: int, n: int, k: int, itemsize: int,
                           epilogue: str, cfg=None,
                           chip: hw.ChipSpec = hw.DEFAULT_CHIP,
                           fused: bool = True) -> int:
    """Bytes for one GEMM + epilogue (bias/activation/residual).

    Unfused, the epilogue is a separate elementwise pass: the (m, n) GEMM
    result is written, re-read together with the epilogue operand, and
    written again. Fused, the epilogue runs in the kernel's flush on the
    f32 accumulator: only the operand read is added, saving
    2*m*n*itemsize bytes."""
    if cfg is None:
        cfg = blocking.choose_block_config(m, n, k, itemsize, chip=chip)
    total = blocking.hbm_traffic_bytes(m, n, k, cfg, itemsize)
    if epilogue == "none":
        return total
    operand = m * n * itemsize if epilogue == "residual" else n * itemsize
    total += operand
    if not fused:
        total += 2 * m * n * itemsize   # write + re-read the intermediate
    return total


def gated_mlp_traffic(m: int, d_model: int, d_ff: int, itemsize: int,
                      *, fused: bool,
                      chip: hw.ChipSpec = hw.DEFAULT_CHIP,
                      cfg_hidden=None, cfg_down=None) -> dict:
    """Bytes for one SwiGLU MLP call, fused vs unfused.

    Unfused: two tiled GEMMs each write their (m, d_ff) result, and the
    gate product reads both and writes a third, three full (m, d_ff)
    round trips beyond the fused path. Fused (`ops.gated_matmul`): one A
    stream feeds both weight operands and only the gated product is
    written. The down projection is the same in both and included, so
    the ratio is per MLP call."""
    if cfg_hidden is None:
        cfg_hidden = blocking.choose_block_config(
            m, d_ff, d_model, itemsize, chip=chip, n_rhs=2 if fused else 1)
    if cfg_down is None:
        cfg_down = blocking.choose_block_config(
            m, d_model, d_ff, itemsize, chip=chip)
    if fused:
        hidden = blocking.gated_traffic_bytes(
            m, d_ff, d_model, cfg_hidden, itemsize)
    else:
        one = blocking.hbm_traffic_bytes(m, d_ff, d_model, cfg_hidden,
                                         itemsize)
        ew = 3 * m * d_ff * itemsize    # read gate, read up, write product
        hidden = 2 * one + ew
    down = blocking.hbm_traffic_bytes(m, d_model, d_ff, cfg_down, itemsize)
    return {
        "hidden_bytes": hidden,
        "down_bytes": down,
        "total_bytes": hidden + down,
        "cfg_hidden": cfg_hidden,
        "cfg_down": cfg_down,
    }


def gated_mlp_savings(m: int, d_model: int, d_ff: int,
                      itemsize: int,
                      chip: hw.ChipSpec = hw.DEFAULT_CHIP) -> dict:
    """Fractional byte saving of the fused SwiGLU MLP."""
    unfused = gated_mlp_traffic(m, d_model, d_ff, itemsize, fused=False,
                                chip=chip)
    fused = gated_mlp_traffic(m, d_model, d_ff, itemsize, fused=True,
                              chip=chip)
    saved = 1.0 - fused["total_bytes"] / unfused["total_bytes"]
    return {"unfused_bytes": unfused["total_bytes"],
            "fused_bytes": fused["total_bytes"],
            "saved_frac": saved,
            "unfused": unfused, "fused": fused}


def _quant_config(m: int, n: int, k: int, itemsize: int, chip, quant: bool):
    """The tile of the int8-weight GEMM (quant) or the GEMM: on a chip
    that runs the port's kernels each kernel's own plan, elsewhere the
    chooser's."""
    if quant and chip.runs_port_kernels:
        return blocking.kernel_block_config("matmul_q", m, n, k, itemsize)
    return blocking.choose_block_config(m, n, k, itemsize, chip=chip)


def quant_gemm_traffic(m: int, n: int, k: int, itemsize: int,
                       *, quant: bool,
                       chip: hw.ChipSpec = hw.DEFAULT_CHIP,
                       cfg=None) -> int:
    """Bytes for one dense-layer GEMM, full-width vs int8 weights.

    Quantized, the weight stream is 1 byte/element plus a (1, N) f32 scale
    row per M-block row (`core.blocking.quant_traffic_bytes`);
    activations, output and the f32 accumulation are untouched: the
    reduction is pure weight-side bandwidth. Without `cfg`, each side
    takes its own kernel's tile."""
    if cfg is None:
        cfg = _quant_config(m, n, k, itemsize, chip, quant)
    if quant:
        return blocking.quant_traffic_bytes(m, n, k, cfg, itemsize)
    return blocking.hbm_traffic_bytes(m, n, k, cfg, itemsize)


def quant_gemm_savings(m: int, n: int, k: int, itemsize: int,
                       chip: hw.ChipSpec = hw.DEFAULT_CHIP) -> dict:
    """Fractional byte saving of the int8-weight GEMM, each side at the
    tile its kernel runs (the int8 kernel's plan on the quantized side;
    the reference takes one tile for both). Weight-bound shapes (decode:
    small m, big n*k) approach the full itemsize/1 reduction,
    activation-bound shapes see less."""
    cfg = _quant_config(m, n, k, itemsize, chip, True)
    full = quant_gemm_traffic(m, n, k, itemsize, quant=False, chip=chip)
    quant = quant_gemm_traffic(m, n, k, itemsize, quant=True, chip=chip,
                               cfg=cfg)
    return {"full_bytes": full,
            "quant_bytes": quant,
            "saved_frac": 1.0 - quant / full,
            "weight_bytes_full": k * n * itemsize,
            "weight_bytes_quant": k * n * 1,
            "cfg": cfg}


def dense_q_layer_savings(m: int, d_model: int, d_ff: int, itemsize: int,
                          chip: hw.ChipSpec = hw.DEFAULT_CHIP) -> dict:
    """Whole-MLP view of the int8 win against the model's real before
    state: unquantized SwiGLU runs the fused dual GEMM (one A stream feeds
    both weights), while the quantized path decomposes into two dense_q
    GEMMs (there is no int8 dual GEMM, so the A stream is paid twice) and
    the int8 down projection."""
    cfg_hidden = blocking.choose_block_config(m, d_ff, d_model, itemsize,
                                              chip=chip, n_rhs=2)
    full = (blocking.gated_traffic_bytes(m, d_ff, d_model, cfg_hidden,
                                         itemsize)
            + quant_gemm_traffic(m, d_model, d_ff, itemsize, quant=False,
                                 chip=chip))
    quant = (2 * quant_gemm_traffic(m, d_ff, d_model, itemsize, quant=True,
                                    chip=chip)
             + quant_gemm_traffic(m, d_model, d_ff, itemsize, quant=True,
                                  chip=chip))
    return {"full_bytes": full, "quant_bytes": quant,
            "saved_frac": 1.0 - quant / full}


def attention_fwd_savings(tq: int, tk: int, d: int, itemsize: int,
                          cfg: blocking.FlashBlockConfig | None = None,
                          chip: hw.ChipSpec = hw.DEFAULT_CHIP) -> dict:
    """Fractional byte saving of the fused flash forward over the
    materialised-softmax baseline, per (batch x head) slice: the missing
    4*tq*tk*4 S/P round trips, bought back by re-streaming K/V once per Q
    block row."""
    if cfg is None:
        cfg = blocking.choose_flash_config(tq, tk, d, itemsize, chip=chip)
    fused = blocking.flash_traffic_bytes(tq, tk, d, cfg, itemsize)
    unfused = blocking.flash_unfused_traffic_bytes(tq, tk, d, itemsize)
    return {"fused_bytes": fused, "unfused_bytes": unfused,
            "saved_frac": 1.0 - fused / unfused, "cfg": cfg}


def decode_attention_savings(pos: int, tk: int, d: int, itemsize: int,
                             cfg: blocking.FlashBlockConfig | None = None,
                             chip: hw.ChipSpec = hw.DEFAULT_CHIP) -> dict:
    """Fractional byte saving of the decode kernel over the masked dense
    scan, per (batch x head): the prefix skip (only the splits that meet
    the ceil((pos+1)/bk)*bk valid rows stream) and the skipped (1, tk) f32
    score-row round trips."""
    if cfg is None:
        cfg = blocking.choose_decode_config(tk, d, itemsize, chip=chip)
    fused = blocking.decode_traffic_bytes(pos, tk, d, cfg, itemsize)
    unfused = blocking.decode_unfused_traffic_bytes(pos, tk, d, itemsize)
    return {"fused_bytes": fused, "unfused_bytes": unfused,
            "saved_frac": 1.0 - fused / unfused, "cfg": cfg}


def attention_bwd_savings(tq: int, tk: int, d: int, itemsize: int,
                          cfg: blocking.FlashBlockConfig | None = None,
                          chip: hw.ChipSpec = hw.DEFAULT_CHIP) -> dict:
    """Fractional byte saving of the recompute-style flash backward over
    the stored-S formulation, per (batch x head). Without `cfg`, the
    backward's own 64 x 64 tile."""
    if cfg is None:
        cfg = blocking.FLASH_BWD_TILE
    fused = blocking.flash_bwd_traffic_bytes(tq, tk, d, cfg, itemsize)
    unfused = blocking.flash_bwd_stored_traffic_bytes(tq, tk, d, itemsize)
    return {"fused_bytes": fused, "unfused_bytes": unfused,
            "saved_frac": 1.0 - fused / unfused, "cfg": cfg}


def ssd_savings(l: int, h: int, p: int, n: int, chunk: int,
                itemsize: int = 4,
                cfg: blocking.SSDBlockConfig | None = None,
                chip: hw.ChipSpec = hw.DEFAULT_CHIP) -> dict:
    """Fractional byte saving of the fused SSD intra-chunk kernel over the
    chunked composition without it: the unfused one materialises, per
    chunk and head, the (Q, Q) decay mask and CB score block in f32
    (write + re-read apiece, the flash story with Q = chunk); the kernel
    keeps both in shared memory."""
    if cfg is None:
        cfg = blocking.choose_ssd_config(chunk, p, n, itemsize, chip=chip)
    fused = blocking.ssd_traffic_bytes(l, h, p, n, cfg, itemsize)
    unfused = blocking.ssd_unfused_traffic_bytes(l, h, p, n, chunk, itemsize)
    return {"fused_bytes": fused, "unfused_bytes": unfused,
            "saved_frac": 1.0 - fused / unfused, "cfg": cfg}


# ----------------------------------------------------------------------
# KV-cache traffic + capacity models (paged / quantized serving)
# ----------------------------------------------------------------------

def kv_decode_traffic_bytes(pos: int, heads: int, d: int, itemsize: int,
                            *, quant_kv: str = "off") -> int:
    """Bytes ONE decode step streams from the KV cache for one slot at
    depth `pos`, summed over K and V: (pos + 1) resident rows per side,
    each `heads * d` elements. quant_kv="int8" rows are 1 byte/element
    plus a 4-byte f32 scale per (position, head)."""
    rows = 2 * (pos + 1) * heads
    if quant_kv == "int8":
        return rows * (d + 4)
    return rows * d * itemsize


def ssm_decode_state_bytes(heads: int, p: int, n: int) -> int:
    """Bytes ONE decode step streams for one slot's SSD recurrent state:
    the (H, P, N) f32 state read and written back once, independent of
    position."""
    return 2 * heads * p * n * 4


def kv_quant_savings(pos: int, heads: int, d: int, itemsize: int) -> dict:
    """Fractional KV-byte saving per decode step of int8 pages over
    full-width rows: d=64 bf16 rows shrink 128 -> 68 bytes/(row, head)
    (46.9%), f32 rows 256 -> 68 (73.4%)."""
    full = kv_decode_traffic_bytes(pos, heads, d, itemsize)
    quant = kv_decode_traffic_bytes(pos, heads, d, itemsize,
                                    quant_kv="int8")
    return {"full_bytes": full, "quant_bytes": quant,
            "saved_frac": 1.0 - quant / full,
            "row_bytes_full": d * itemsize, "row_bytes_quant": d + 4}


def kv_capacity_model(pool_bytes: int, *, max_len: int, page_size: int,
                      heads: int, d: int, itemsize: int, prompt_len: int,
                      shared_prefix_len: int, gen: int,
                      quant_kv: str = "off") -> dict:
    """Concurrent-slot capacity of one layer's KV memory under three
    layouts at an equal byte budget: dense (every slot pins max_len
    rows), paged (ceil((prompt+gen)/page_size) pages a slot, the shared
    prefix's pages paid once pool-wide) and paged with int8 pages."""
    row_full = 2 * heads * d * itemsize          # K + V, one position
    row = 2 * heads * (d + 4) if quant_kv == "int8" else row_full
    dense_slots = pool_bytes // (max_len * row_full)
    n_pages = pool_bytes // (page_size * row)
    shared_pages = shared_prefix_len // page_size   # full pages only
    per_req = -(-(prompt_len + gen) // page_size) - shared_pages
    paged_slots = max(0, (n_pages - shared_pages) // max(per_req, 1))
    return {"dense_slots": int(dense_slots),
            "paged_slots": int(paged_slots),
            "n_pages": int(n_pages),
            "shared_pages": int(shared_pages),
            "pages_per_request": int(per_req),
            "capacity_ratio": paged_slots / max(dense_slots, 1)}


# ----------------------------------------------------------------------
# The report
# ----------------------------------------------------------------------

#: Appended to every report's note.
COUNTED_NOTE = ("counted from one eager run (roofline.counter); the "
                "replays of a CUDA graph are not counted")


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    kind: str
    n_devices: int
    hlo_flops_per_device: float
    hbm_bytes_per_device: float
    ici_bytes_per_device: float
    collectives: dict
    t_compute: float
    t_memory: float
    t_collective: float
    bound: str
    model_flops_total: float
    useful_ratio: float          # MODEL_FLOPS / (counted FLOPs * devices)
    mfu_roofline: float          # useful-compute-time / dominant term
    memory_analysis: dict
    note: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def summary_line(self) -> str:
        return (f"{self.arch:16s} {self.shape:12s} {self.mesh:10s} "
                f"tc={self.t_compute*1e3:9.3f}ms tm={self.t_memory*1e3:9.3f}ms "
                f"tcoll={self.t_collective*1e3:9.3f}ms bound={self.bound:10s} "
                f"useful={self.useful_ratio:6.3f} mfu*={self.mfu_roofline:6.3f}")


def build_report(
    cfg, cell, *, kind: str, costs, mesh_name: str = "1",
    n_devices: int = 1, memory_analysis: dict | None = None,
    chip: hw.ChipSpec = hw.DEFAULT_CHIP, note: str = "",
) -> RooflineReport:
    """The roofline of a counted step: `costs` is `roofline.counter`'s
    Costs of one eager run (in place of the reference's HLO text), one
    rank's on a mesh of `n_devices` (`mesh_name`). The collective term is
    the ring-model link bytes of the collectives the run dispatched
    (`Costs.ici_bytes`) over one NVLink link's rate, `chip.nvlink_bw`
    (the data sheet's, not measured), as the reference divides by one ICI
    link's; the note says so where there are any. memory_analysis: a
    dict to report, else the counted run's `torch.cuda.max_memory_allocated`
    on the card (empty on the CPU)."""
    peak = chip.peak_flops_bf16
    t_c = costs.flops / peak
    t_m = costs.hbm_bytes / chip.hbm_bw
    t_coll = costs.ici_bytes / chip.nvlink_bw
    terms = {"compute": t_c, "memory": t_m, "collective": t_coll}
    bound = max(terms, key=terms.get)
    mf = model_flops(cfg, cell, kind=kind)
    useful = mf / max(costs.flops * n_devices, 1.0)
    t_useful = mf / n_devices / peak
    mfu = t_useful / max(max(terms.values()), 1e-30)
    if memory_analysis is None:
        memory_analysis = {} if costs.peak_bytes is None else \
            {"max_memory_allocated": costs.peak_bytes}
    return RooflineReport(
        arch=cfg.name, shape=cell.name, mesh=mesh_name, kind=kind,
        n_devices=n_devices,
        hlo_flops_per_device=costs.flops,
        hbm_bytes_per_device=costs.hbm_bytes,
        ici_bytes_per_device=costs.ici_bytes,
        collectives=costs.collective_summary(),
        t_compute=t_c, t_memory=t_m, t_collective=t_coll, bound=bound,
        model_flops_total=mf, useful_ratio=useful, mfu_roofline=mfu,
        memory_analysis=dict(memory_analysis),
        note="; ".join(x for x in (note, COUNTED_NOTE, _link_note(
            costs, chip)) if x),
    )


def _link_note(costs, chip) -> str:
    if not costs.collectives:
        return ""
    return (f"collective term: ring-model link bytes over one NVLink link "
            f"({chip.name}'s nvlink_bw, {chip.nvlink_bw / 1e9:g} GB/s a "
            f"direction, one of its {chip.nvlink_links} links; the data "
            f"sheet's, not measured)")


def save_report(report: RooflineReport, path: str) -> None:
    with open(path, "w") as f:
        json.dump(report.to_json(), f, indent=2)


# ----------------------------------------------------------------------
# The charges of the kernel ops (`kernels.ops`) under the counter
# ----------------------------------------------------------------------

class Charge(NamedTuple):
    """What one call of a kernel op costs: `kernel` its launch counter's
    name (`ops.launch_counts()`), its FLOPs in two conventions and its
    compulsory bytes. `flops` is what the reference's XLA route counts for
    the same call: every (query, key) pair of causal flash attention and
    the whole (Q, Q) square of an SSD chunk. `kept_flops` is what the
    kernel computes on these inputs, the pairs its mask keeps: the least
    work, which a bound counts. The two differ only for the flash and SSD
    ops; decode attention charges only the keys up to each slot's
    position in both."""
    kernel: str
    flops: float
    kept_flops: float
    hbm_bytes: float
    what: str


def _nb(t) -> int:
    return t.numel() * t.element_size()


def _gemm(kernel, flops, nbytes, *dims, dtype):
    return Charge(kernel, float(flops), float(flops), float(nbytes),
                  "x".join(map(str, dims)) + f" {str(dtype).removeprefix('torch.')}")


def matmul_charge(a, b, *, out_dtype=None, epilogue="none", bias=None,
                  residual=None) -> Charge:
    """`ops.matmul`: 2·M·N·K; A, B, the epilogue's operand and C once."""
    m, k = a.shape
    n = b.shape[1]
    out = (out_dtype or a.dtype).itemsize
    e = residual if epilogue == "residual" else \
        bias if epilogue != "none" else None
    return _gemm("matmul", 2 * m * n * k,
                 _nb(a) + _nb(b) + m * n * out + (0 if e is None else _nb(e)),
                 m, k, n, dtype=a.dtype)


def matmul_q_charge(a, wq, scale, *, out_dtype=None, epilogue="none",
                    bias=None, residual=None) -> Charge:
    """`ops.matmul_q`: 2·M·N·K; A, the int8 weights, their scale row, the
    epilogue's operand and C once."""
    m, k = a.shape
    n = wq.shape[1]
    out = (out_dtype or a.dtype).itemsize
    e = residual if epilogue == "residual" else \
        bias if epilogue != "none" else None
    return _gemm("matmul_q", 2 * m * n * k,
                 _nb(a) + _nb(wq) + _nb(scale) + m * n * out
                 + (0 if e is None else _nb(e)), m, k, n, dtype=a.dtype)


def gated_matmul_charge(a, w_gate, w_up) -> Charge:
    """`ops.gated_matmul`: two GEMMs, 4·M·N·K; A, both weights and the
    gated product once."""
    (m, k), n = a.shape, w_gate.shape[1]
    return _gemm("gated_matmul", 4 * m * n * k,
                 _nb(a) + _nb(w_gate) + _nb(w_up) + m * n * a.element_size(),
                 m, k, n, dtype=a.dtype)


def matmul_batched_charge(a, b) -> Charge:
    """`ops.matmul_batched`: 2·E·M·N·K; A, the bank and C once."""
    e, m, k = a.shape
    n = b.shape[2]
    return _gemm("matmul_batched", 2 * e * m * n * k,
                 _nb(a) + _nb(b) + e * m * n * a.element_size(),
                 e, m, k, n, dtype=a.dtype)


def gated_matmul_batched_charge(a, w_gate, w_up) -> Charge:
    """`ops.gated_matmul_batched`: 4·E·M·N·K; A, both banks and H once."""
    e, m, k = a.shape
    n = w_gate.shape[2]
    return _gemm("gated_matmul_batched", 4 * e * m * n * k,
                 _nb(a) + _nb(w_gate) + _nb(w_up) + e * m * n * a.element_size(),
                 e, m, k, n, dtype=a.dtype)


def matmul_naive_charge(a, b, *, out_dtype=None) -> Charge:
    """`ops.matmul_naive`: 2·M·N·K; A, B and C once (the kernel reads
    them n and m times: the naive traffic model's, not compulsory)."""
    m, k = a.shape
    n = b.shape[1]
    return _gemm("matmul_naive", 2 * m * n * k,
                 _nb(a) + _nb(b) + m * n * (out_dtype or a.dtype).itemsize,
                 m, k, n, dtype=a.dtype)


def binary_charge(a, b) -> Charge:
    """`ops.add` / `ops.sub` (the binary_op kernel): one operation an
    element (two for complex: its real and imaginary parts); a, b and the
    result once."""
    n = a.numel() * (2 if a.is_complex() else 1)
    return Charge("binary_op", float(n), float(n), float(3 * _nb(a)),
                  f"{tuple(a.shape)} {str(a.dtype).removeprefix('torch.')}")


def axpy_charge(alpha, x, y) -> Charge:
    """`ops.axpy`: a multiply and an add an element; alpha (a tensor's
    bytes), x, y and the result once."""
    a = _nb(alpha) if isinstance(alpha, torch.Tensor) else 0
    return Charge("axpy", 2.0 * x.numel(), 2.0 * x.numel(),
                  float(3 * _nb(x) + a),
                  f"{tuple(x.shape)} {str(x.dtype).removeprefix('torch.')}")


def _host_ints(v, b: int, default: int) -> list:
    """A (B,) tensor, an int (broadcast) or None (`default`) as B ints:
    a tensor on the card is read on the host, which only a counted step
    does (never under graph capture)."""
    if v is None:
        return [default] * b
    if isinstance(v, torch.Tensor) and v.dim() == 1:
        return [int(x) for x in v.tolist()]
    return [int(v)] * b


def decode_keys(pos, n_valid, b: int, t: int, tk: int, window,
                page_size: int = 0):
    """(keys, pairs, pages) of a decode call: the keys its slots' rows see
    together (a slot's first row's lowest key to its last real row's
    position), the (row, key) pairs they score, and the pages those keys
    lie on. A slot at pos < 0 sees none; row r sits at pos + r and rows
    r >= n_valid see none; with a window a row at p sees keys
    p - window + 1 .. p."""
    keys = pairs = pages = 0
    for p, nv in zip(_host_ints(pos, b, 0), _host_ints(n_valid, b, t)):
        if p < 0 or nv < 1:
            continue
        for r in range(nv):
            at = p + r
            lo = max(0, at - window + 1) if window else 0
            pairs += max(0, min(at, tk - 1) - lo + 1)
        lo = max(0, p - window + 1) if window else 0
        hi = min(p + nv - 1, tk - 1)
        if hi >= lo:
            keys += hi - lo + 1
            if page_size:
                pages += hi // page_size - lo // page_size + 1
    return keys, pairs, pages


def _aux_bytes(*ts) -> int:
    return sum(_nb(t) for t in ts if isinstance(t, torch.Tensor))


def flash_decode_charge(q, k, v, *, pos=0, window=None,
                        n_valid=None) -> Charge:
    """`ops.flash_decode`: 4·H·D a (row, key) pair it scores; q, the
    output, the K and V rows of the keys its slots see, and the pos and
    n_valid vectors once. Only the keys up to each slot's position count,
    as only the splits that meet them run; the positions are read on the
    host."""
    b, t, h, d = q.shape
    keys, pairs, _ = decode_keys(pos, n_valid, b, t, k.shape[1], window)
    return Charge("flash_decode" if t == 1 else "flash_decode_rows",
                  4.0 * pairs * h * d, 4.0 * pairs * h * d,
                  float(2 * _nb(q) + 2 * keys * k.shape[2] * d * k.element_size()
                        + _aux_bytes(pos, n_valid)),
                  f"B={b} T={t} H={h} Hkv={k.shape[2]} D={d} keys={keys}")


def flash_decode_paged_charge(q, kp, vp, table, *, pos=0, window=None,
                              ks=None, vs=None, n_valid=None) -> Charge:
    """`ops.flash_decode_paged`: as `flash_decode_charge`, the K and V rows
    at the pool's element size with an int8 pool's f32 scale a (row, KV
    head), and the page-table entries of the pages those keys lie on."""
    b, t, h, d = q.shape
    ps, hkv = kp.shape[1], kp.shape[2]
    keys, pairs, pages = decode_keys(pos, n_valid, b, t,
                                     table.shape[1] * ps, window, ps)
    row = hkv * (d * kp.element_size() + (4 if ks is not None else 0))
    return Charge("flash_decode_paged" if t == 1 else
                  "flash_decode_paged_rows", 4.0 * pairs * h * d,
                  4.0 * pairs * h * d,
                  float(2 * _nb(q) + 2 * keys * row
                        + pages * table.element_size()
                        + _aux_bytes(pos, n_valid)),
                  f"B={b} T={t} H={h} Hkv={hkv} D={d} ps={ps} keys={keys}")


def attention_pairs(tq: int, tk: int, causal: bool, window) -> int:
    """(query, key) pairs a flash call's mask keeps: query row i sees keys
    j <= i under `causal`, and j > i - window with a window."""
    total = 0
    for i in range(tq):
        lo = max(0, i - window + 1) if window else 0
        hi = min(i, tk - 1) if causal else tk - 1
        total += max(0, hi - lo + 1)
    return total


def _flash(kernel, q, k, v, causal, window, per_pair, per_full,
           nbytes) -> Charge:
    b, tq, h, d = q.shape
    tk = k.shape[1]
    kept = per_pair * b * h * attention_pairs(tq, tk, causal, window) * d
    return Charge(kernel, float(per_full * b * h * tq * tk * d), float(kept),
                  float(nbytes),
                  f"B={b} Tq={tq} Tk={tk} H={h} Hkv={k.shape[2]} D={d} "
                  f"causal={causal} window={window}")


def flash_attention_fwd_charge(q, k, v, *, causal=True,
                               window=None) -> Charge:
    """`ops.flash_attention_fwd`: q, k, v, o and the f32 lse once. FLOPs:
    the reference's XLA route's for the same call, 4·B·H·Tq·Tk·D, every
    (query, key) pair of the two products whatever the mask; kept FLOPs
    the pairs the mask keeps (the kernel skips the rest)."""
    b, tq, h, _ = q.shape
    return _flash("flash_attention", q, k, v, causal, window, 4, 4, 2 * _nb(q) + _nb(k) + _nb(v) + b * h * tq * 4)


def flash_attention_charge(q, k, v, *, causal=True, window=None) -> Charge:
    """`ops.flash_attention`: `flash_attention_fwd_charge` less the lse."""
    return _flash("flash_attention", q, k, v, causal, window, 4, 4,
                  2 * _nb(q) + _nb(k) + _nb(v))


def flash_attention_bwd_charge(q, k, v, o, do, lse, *, causal=True,
                               window=None) -> Charge:
    """`ops.flash_attention_bwd`: q, k, v, o, do and lse read, dq, dk and
    dv written, once. FLOPs: what the reference's XLA route counts for the
    backward of the same call, autodiff of the forward's two products,
    8·B·H·Tq·Tk·D over every pair; kept FLOPs the kernel's over the pairs
    the mask keeps, 10 products a pair (S recomputed, dV, dP, dQ, dK)."""
    nbytes = 2 * (_nb(q) + _nb(k) + _nb(v)) + _nb(o) + _nb(do) + _nb(lse)
    return _flash("flash_attention_bwd", q, k, v, causal, window, 10, 8,
                  nbytes)


def _ssd_flops(b, l, h, p, n, chunk, kept: bool, scan: bool) -> float:
    """The intra-chunk products (C B^T, S x and the chunk state a head and
    chunk; `kept`: the causal half of the first two, the pairs the kernel
    computes; else the whole (Q, Q) square, as a dense lowering computes
    them) and, with `scan`, the scan's state -> output products and its
    recurrence."""
    nc = l // chunk
    sq = chunk * (chunk + 1) // 2 if kept else chunk * chunk
    flops = b * h * nc * (2 * sq * n + 2 * sq * p + 2 * chunk * n * p)
    if scan:
        flops += 2 * b * h * (l + nc) * n * p
    return float(flops)


def ssd_charge(x, a, b, c, chunk, init_state=None) -> Charge:
    """`ops.ssd`: x, a, B, C and the initial state read, y and the f32
    final state written, once; FLOPs `_ssd_flops` with the scan."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    nbytes = (_nb(x) + _nb(a) + _nb(b) + _nb(c) + _aux_bytes(init_state)
              + _nb(x) + bsz * h * p * n * 4)
    return Charge("ssd", _ssd_flops(bsz, l, h, p, n, chunk, False, True),
                  _ssd_flops(bsz, l, h, p, n, chunk, True, True),
                  float(nbytes), f"B={bsz} L={l} H={h} P={p} N={n} "
                  f"chunk={chunk}")


def ssd_intra_chunk_charge(x, a, b, c, chunk) -> Charge:
    """`kernels.ssd.ssd_intra_chunk` alone: x, a, B, C read, the f32
    y_diag and chunk states written, once; the intra-chunk products."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    nbytes = (_nb(x) + _nb(a) + _nb(b) + _nb(c) + x.numel() * 4
              + bsz * h * (l // chunk) * n * p * 4)
    return Charge("ssd", _ssd_flops(bsz, l, h, p, n, chunk, False, False),
                  _ssd_flops(bsz, l, h, p, n, chunk, True, False),
                  float(nbytes), f"B={bsz} L={l} H={h} P={p} N={n} "
                  f"chunk={chunk} intra")
