"""Benchmark-driven instance search.

The port's copy of the JAX package's `tuning/autotuner.py`. For one
shape of one op it times every candidate of its space (`tuning.space`)
in turns on the card, with the clock `chip_smoke.py`'s kernel tables
read (`tuning.timing`), and keeps the winner in the fingerprint-keyed
cache (`tuning.cache`) whose winners the GEMM plans serve while
`tuning.cache.set_tuned` is on. The static plan is candidate 0 and is
timed in the same turns, so a winner is never slower than it by the
same clock. Every candidate gives the static plan's bits.

Entry points:
  tune_matmul / tune_gated_matmul / tune_flash_* / tune_ssd: sweep one
      shape, cache the winner
  warm_start: the launchers' hook: check the cache for a model config's
      GEMM shapes, and tune the misses with autotune=True

A GEMM's key holds no layout, so a shape is timed in every layout the
model's step runs it in (`model_gemm_layouts`: the tied logits read the
embedding table in place, the backward's GEMMs transpose views), each
candidate's time the sum over them. Unlike the reference's `_sweep`, a
candidate that faults is not caught: a CUDA error is sticky, and every
later timing would be spoilt.
"""

from __future__ import annotations

import collections
import dataclasses
import math

import torch

from repro_torch.core import precision as _prec
from repro_torch.core.device import resolve_device
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import ops as _ops
from repro_torch.tuning import space as _space
from repro_torch.tuning import timing as _timing
from repro_torch.tuning.cache import (BACKEND, TuningCache, dtype_name,
                                      get_cache)


#: A GEMM call's layout: (A read as the transpose view of a row-major
#: [K, M], B as that of a row-major [N, K], the output dtype's name or
#: None for A's dtype).
ROW_MAJOR = (False, False, None)

#: The ops whose space is one instance (`tuning.space`): nothing to time.
ONE_INSTANCE = ("flash", "flash_bwd", "flash_decode", "flash_decode_paged",
                "ssd")


def default_exec_backend() -> str:
    """The backend whose timings the cache keys: the CUDA kernels."""
    return BACKEND


@dataclasses.dataclass(frozen=True)
class TuneResult:
    op: str                      # "matmul" | "matmul_q" | "gated" | "flash" ...
    key: str                     # cache key the winner was stored under
    backend: str                 # the tag of the key ("cuda")
    best: object                 # a TilePlan | FlashBlockConfig | SSDBlockConfig
    best_s: float
    baseline: object             # the static plan
    baseline_s: float
    trials: tuple                # ((candidate, seconds), ...) in sweep order
    layouts: tuple = (ROW_MAJOR,)  # the GEMM layouts each trial summed

    @property
    def speedup(self) -> float:
        return self.baseline_s / self.best_s if self.best_s > 0 else 1.0


def card_timer(device, warmup: int = 2, iters: int = 10):
    """The sweep's clock: seconds of each zero-argument callable, timed in
    turns by `timing.time_turns` (raises off the card)."""
    def timer(fns):
        return [ms / 1e3 for ms in _timing.time_turns(
            fns, device=device, n=iters, warmup=warmup)]
    return timer


def _timing_meta(best_s: float, baseline_s: float) -> dict:
    meta = {"time_us": round(best_s * 1e6, 2)}
    if math.isfinite(baseline_s) and best_s > 0:
        meta["baseline_us"] = round(baseline_s * 1e6, 2)
        meta["speedup"] = round(baseline_s / best_s, 4)
    return meta


def _sweep(op: str, desc: str, candidates, run, put_winner,
           cache: TuningCache, save: bool, timer,
           layouts: tuple = (ROW_MAJOR,)) -> TuneResult:
    """Shared sweep of every tune_* entry point: time each candidate's
    `run(candidate)` (a zero-argument callable) in turns with `timer`,
    take the fastest against the static plan (candidate 0, which a tie
    keeps), store it through put_winner, and package the TuneResult. A
    candidate that raises ends the sweep with its error."""
    if not candidates:
        raise ValueError(f"no candidate for {desc}")
    times = timer([run(c) for c in candidates])
    trials = tuple(zip(candidates, times))
    baseline_cfg, baseline_s = trials[0]
    best_cfg, best_s = min(trials, key=lambda ct: ct[1])
    key = put_winner(best_cfg, _timing_meta(best_s, baseline_s))
    if save:
        cache.save()
    return TuneResult(op, key, BACKEND, best_cfg, best_s, baseline_cfg,
                      baseline_s, trials, layouts)


def _setup(dtype, cache, device, warmup, iters, timer, seed):
    """(dtype name, cache, device, timer, a seeded randn on the device)."""
    dt = dtype_name(dtype)
    if dt not in ("bfloat16", "float32"):
        raise ValueError(f"the port's kernels take bfloat16 or float32, "
                         f"not {dt}")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, dtype=getattr(torch, dt), scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(dtype)
    return (dt, get_cache() if cache is None else cache, device,
            timer or card_timer(device, warmup, iters), randn)


def tune_matmul(
    m: int,
    n: int,
    k: int,
    dtype="bfloat16",
    *,
    epilogue: str = "none",
    quant: str | None = None,
    layouts=None,
    cache: TuningCache | None = None,
    device=None,
    warmup: int = 2,
    iters: int = 10,
    max_candidates: int | None = None,
    save: bool = True,
    seed: int = 0,
    timer=None,
) -> TuneResult:
    """Sweep the instances of one GEMM shape and cache the winner.

    `epilogue` times the fused flush (bias / bias_gelu / bias_silu /
    residual) with its operand; each epilogue has its own entry. `quant`
    "int8" quantizes the weight and sweeps the int8-weight GEMM, whose
    winners have their own keys (`cache.matmul_q_key`); None or "off"
    the plain GEMM. `layouts`: the (a_km, b_nk, out dtype) triples a
    candidate runs in, one call each, its time their sum (default
    row-major operands, A's dtype out; the int8-weight GEMM takes a
    row-major A and its own weight, so only the out dtype). `timer`: the
    clock (default `card_timer`, which raises off the card)."""
    quant = "off" if quant is None else quant
    if quant not in ("off", "int8"):
        raise ValueError(f"unknown quant mode {quant!r}; expected one of "
                         f"('off', 'int8')")
    quantized = quant == "int8"
    layouts = tuple(layouts or (ROW_MAJOR,))
    if quantized and any(t_a or t_b for t_a, t_b, _ in layouts):
        raise ValueError(f"the int8-weight GEMM takes row-major operands, "
                         f"not the layouts {layouts}")
    dt, cache, device, timer, randn = _setup(dtype, cache, device, warmup,
                                             iters, timer, seed)
    a = {t: randn(k, m).t() if t else randn(m, k)
         for t in {t_a for t_a, _, _ in layouts}}
    w = randn(k, n, dtype=torch.float32, scale=k ** -0.5)
    e = None
    if epilogue == "residual":
        e = randn(m, n)
    elif epilogue != "none":
        e = randn(n)
    outs = [(t_a, t_b, None if out is None else getattr(torch, out))
            for t_a, t_b, out in layouts]
    if quantized:
        wq, scale = _prec.quantize_int8(w)
        scale = scale.reshape(n)
        run = lambda p: lambda: [_mm.matmul_q_tiled(
            a[False], wq, scale, out_dtype=out, epilogue=epilogue,
            epilogue_operand=e, plan=p) for _, _, out in outs]
        put_winner = lambda p, meta: cache.put_matmul_q(
            m, n, k, dt, p, epilogue=epilogue, **meta)
    else:
        wt = w.to(getattr(torch, dt))
        b = {t: wt.t().contiguous().t() if t else wt
             for t in {t_b for _, t_b, _ in layouts}}
        run = lambda p: lambda: [_mm.matmul_tiled(
            a[t_a], b[t_b], out_dtype=out, epilogue=epilogue,
            epilogue_operand=e, plan=p) for t_a, t_b, out in outs]
        put_winner = lambda p, meta: cache.put_matmul(
            m, n, k, dt, p, epilogue=epilogue, **meta)
    op = "matmul_q" if quantized else "matmul"
    return _sweep(
        op, f"{op} {m}x{n}x{k} {dt} epilogue={epilogue}",
        _space.matmul_candidates(m, n, k, dt, quant=quantized,
                                 layouts=layouts,
                                 max_candidates=max_candidates),
        run, put_winner, cache, save, timer, layouts)


def tune_gated_matmul(
    m: int,
    n: int,
    k: int,
    dtype="bfloat16",
    *,
    cache: TuningCache | None = None,
    device=None,
    warmup: int = 2,
    iters: int = 10,
    max_candidates: int | None = None,
    save: bool = True,
    seed: int = 0,
    timer=None,
) -> TuneResult:
    """Sweep the dual GEMM's instances for one shape; cache the winner."""
    dt, cache, device, timer, randn = _setup(dtype, cache, device, warmup,
                                             iters, timer, seed)
    a = randn(m, k)
    wg = randn(k, n, scale=k ** -0.5)
    wu = randn(k, n, scale=k ** -0.5)
    return _sweep(
        "gated", f"gated {m}x{n}x{k} {dt}",
        _space.gated_matmul_candidates(m, n, k, dt,
                                       max_candidates=max_candidates),
        lambda p: lambda: _mm.gated_matmul_tiled(a, wg, wu, plan=p),
        lambda p, meta: cache.put_gated(m, n, k, dt, p, **meta),
        cache, save, timer)


def tune_flash_attention(
    tq: int,
    tk: int,
    d: int,
    dtype="bfloat16",
    *,
    heads: int = 1,
    causal: bool = True,
    cache: TuningCache | None = None,
    device=None,
    warmup: int = 2,
    iters: int = 10,
    max_candidates: int | None = None,
    save: bool = True,
    seed: int = 0,
    timer=None,
) -> TuneResult:
    """Time the flash forward at one shape (a space of one) and cache it."""
    dt, cache, device, timer, randn = _setup(dtype, cache, device, warmup,
                                             iters, timer, seed)
    q = randn(1, tq, heads, d)
    kv = randn(1, tk, heads, d)
    return _sweep(
        "flash", f"flash {tq}x{tk}xd{d} {dt}",
        _space.flash_candidates(tq, tk, d, dt),
        lambda c: lambda: _ops.flash_attention_fwd(q, kv, kv, causal=causal),
        lambda c, meta: cache.put_flash(tq, tk, d, dt, c, **meta),
        cache, save, timer)


def tune_flash_decode(
    tk: int,
    d: int,
    dtype="bfloat16",
    *,
    batch: int = 4,
    heads: int = 1,
    pos: int | None = None,
    window: int | None = None,
    cache: TuningCache | None = None,
    device=None,
    warmup: int = 2,
    iters: int = 10,
    max_candidates: int | None = None,
    save: bool = True,
    seed: int = 0,
    timer=None,
) -> TuneResult:
    """Time the decode kernel over a depth-tk cache (a space of one) and
    cache it under flash_decode_key; `pos` defaults to a full cache."""
    dt, cache, device, timer, randn = _setup(dtype, cache, device, warmup,
                                             iters, timer, seed)
    q = randn(batch, 1, heads, d)
    kv = randn(batch, tk, heads, d)
    pos_v = torch.full((batch,), tk - 1 if pos is None else pos,
                       dtype=torch.int32, device=device)
    return _sweep(
        "flash_decode", f"flash_decode {tk}xd{d} {dt}",
        _space.flash_decode_candidates(tk, d, dt),
        lambda c: lambda: _ops.flash_decode(q, kv, kv, pos=pos_v,
                                            window=window),
        lambda c, meta: cache.put_flash_decode(tk, d, dt, c, **meta),
        cache, save, timer)


def tune_flash_decode_paged(
    page_size: int,
    d: int,
    dtype="bfloat16",
    *,
    batch: int = 4,
    heads: int = 1,
    pages_per_slot: int = 4,
    pos: int | None = None,
    window: int | None = None,
    quant_kv: str = "off",
    cache: TuningCache | None = None,
    device=None,
    warmup: int = 2,
    iters: int = 10,
    max_candidates: int | None = None,
    save: bool = True,
    seed: int = 0,
    timer=None,
) -> TuneResult:
    """Time the paged decode kernel (a space of one) over a pool that maps
    slot b's pages to b * pp + j at full depth, int8 pages with
    quant_kv="int8", and cache it under flash_decode_paged_key."""
    dt, cache, device, timer, randn = _setup(dtype, cache, device, warmup,
                                             iters, timer, seed)
    pp = pages_per_slot
    n_pages = batch * pp
    q = randn(batch, 1, heads, d)
    kp = randn(n_pages, page_size, heads, d)
    vp = randn(n_pages, page_size, heads, d)
    table = torch.arange(n_pages, dtype=torch.int32,
                         device=device).reshape(batch, pp)
    pos_v = torch.full((batch,), pp * page_size - 1 if pos is None else pos,
                       dtype=torch.int32, device=device)
    ks = vs = None
    if quant_kv == "int8":
        kp, ks = _prec.quantize_kv(kp)
        vp, vs = _prec.quantize_kv(vp)
        ks = ks.transpose(1, 2).contiguous()       # (P, Hkv, page_size)
        vs = vs.transpose(1, 2).contiguous()
    return _sweep(
        "flash_decode_paged", f"flash_decode_paged p{page_size}xd{d} {dt}",
        _space.flash_decode_paged_candidates(page_size, d, dt),
        lambda c: lambda: _ops.flash_decode_paged(
            q, kp, vp, table, pos=pos_v, window=window, ks=ks, vs=vs),
        lambda c, meta: cache.put_flash_decode_paged(page_size, d, dt, c,
                                                     **meta),
        cache, save, timer)


def tune_flash_bwd(
    tq: int,
    tk: int,
    d: int,
    dtype="bfloat16",
    *,
    heads: int = 1,
    causal: bool = True,
    cache: TuningCache | None = None,
    device=None,
    warmup: int = 2,
    iters: int = 10,
    max_candidates: int | None = None,
    save: bool = True,
    seed: int = 0,
    timer=None,
) -> TuneResult:
    """Time the two-sweep backward (a space of one) from one untimed
    forward's (o, lse), and cache it under flash_bwd_key."""
    dt, cache, device, timer, randn = _setup(dtype, cache, device, warmup,
                                             iters, timer, seed)
    q = randn(1, tq, heads, d)
    kv = randn(1, tk, heads, d)
    do = randn(1, tq, heads, d)
    o, lse = _ops.flash_attention_fwd(q, kv, kv, causal=causal)
    return _sweep(
        "flash_bwd", f"flash_bwd {tq}x{tk}xd{d} {dt}",
        _space.flash_bwd_candidates(tq, tk, d, dt),
        lambda c: lambda: _ops.flash_attention_bwd(q, kv, kv, o, do, lse,
                                                   causal=causal),
        lambda c, meta: cache.put_flash_bwd(tq, tk, d, dt, c, **meta),
        cache, save, timer)


def tune_ssd(
    chunk: int,
    p: int,
    n: int,
    dtype="float32",
    *,
    heads: int = 4,
    groups: int = 1,
    batch: int = 1,
    seqlen: int | None = None,
    cache: TuningCache | None = None,
    device=None,
    warmup: int = 2,
    iters: int = 10,
    max_candidates: int | None = None,
    save: bool = True,
    seed: int = 0,
    timer=None,
) -> TuneResult:
    """Time the SSD scan's intra-chunk kernel (a space of one) over
    `seqlen` (default 4 model chunks) and cache it under ssd_key; decays
    are drawn negative, as a Mamba-2 layer's always are."""
    dt, cache, device, timer, randn = _setup(dtype, cache, device, warmup,
                                             iters, timer, seed)
    l = seqlen or 4 * chunk
    if l % chunk:
        raise ValueError(f"seqlen {l} must be a multiple of chunk {chunk}")
    x = randn(batch, l, heads, p)
    a = -randn(batch, l, heads, dtype=torch.float32).abs() * 0.1
    b = randn(batch, l, groups, n)
    c = randn(batch, l, groups, n)
    return _sweep(
        "ssd", f"ssd Q{chunk}xP{p}xN{n} {dt}",
        _space.ssd_candidates(chunk, p, n, dt),
        lambda cfg: lambda: _ops.ssd(x, a, b, c, chunk),
        lambda cfg, meta: cache.put_ssd(chunk, p, n, dt, cfg, **meta),
        cache, save, timer)


def model_ssd_shapes(cfg, batch: int = 1, seq: int = 1) -> list[tuple]:
    """The SSD shapes a step of `cfg` routes through core.ssd, as
    deduplicated ``(op, chunk, P, N, "-")`` entries mirroring the other
    model_*_shapes 5-tuple layout. Both pure-SSM and hybrid families
    contribute (every mamba layer shares one shape); attention-only
    configs contribute nothing. `batch`/`seq` are accepted for signature
    symmetry: the SSD key depends only on (chunk, P, N)."""
    del batch, seq
    sc = getattr(cfg, "ssm", None)
    if sc is None or getattr(cfg, "family", None) not in ("ssm", "hybrid"):
        return []
    return [("ssd", sc.chunk, sc.head_dim, sc.d_state, "-")]


def model_attention_shapes(cfg, batch: int, seq: int,
                           backward: bool = False,
                           decode_len: int | None = None) -> list[tuple]:
    """The flash-kernel shapes a (batch, seq) step of `cfg` runs, as
    deduplicated ``(op, tq, tk, d, "-")`` entries: op "flash" (the
    forward), "flash_bwd" (training's backward, with backward=True) or
    "flash_decode" (``(op, 1, decode_len, d, "-")``, when a cache depth
    is given). Attention shapes are a (batch x head) slice's, so `batch`
    does not enter the keys. Pure-SSM configs contribute nothing."""
    del batch
    if getattr(cfg, "family", None) == "ssm" or \
            not getattr(cfg, "n_heads", 0):
        return []
    head_dim = getattr(cfg, "resolved_head_dim",
                       cfg.head_dim or cfg.d_model // cfg.n_heads)
    entries = set()
    if seq > 1:
        entries.add(("flash", seq, seq, head_dim, "-"))
        if backward:
            entries.add(("flash_bwd", seq, seq, head_dim, "-"))
    if decode_len:
        entries.add(("flash_decode", 1, decode_len, head_dim, "-"))
    return sorted(entries)


def model_gemm_shapes(cfg, batch: int, seq: int,
                      backward: bool = False,
                      quant: bool = False) -> list[tuple]:
    """The dense contractions a (batch, seq) step of `cfg` pushes through
    the GEMM chokepoint, as deduplicated ``(op, m, n, k, epilogue)``
    entries: op "matmul" (the GEMM with its epilogue), "matmul_q" (the
    int8-weight GEMM) or "gated" (the dual GEMM, epilogue "-"). Covers
    the attention projections, the FFN (the gated hidden phase and the
    residual down projection, or the gelu MLP's bias flushes) and the
    logits GEMM at the padded vocab.

    quant=True describes the model after `models.model.quantize_params`:
    dense layers run matmul_q, a gated layer two matmul_q GEMMs of the
    hidden shape, and a tied lm_head keeps the plain GEMM.

    backward=True adds each forward shape's cotangent GEMMs, dA = g W^T
    (m, k, n) and dW = X^T g (k, n, m), and its plain recompute (m, n, k),
    all epilogue-free and on the plain GEMM."""
    m = batch * seq
    head_dim = getattr(cfg, "resolved_head_dim",
                       cfg.head_dim or cfg.d_model // cfg.n_heads)
    vocab = getattr(cfg, "padded_vocab", cfg.vocab)
    qkv_ep = "bias" if getattr(cfg, "qkv_bias", False) else "none"
    dense_op = "matmul_q" if quant else "matmul"
    logits_op = "matmul" if getattr(cfg, "tie_embeddings", False) \
        else dense_op
    entries = {
        (dense_op, m, cfg.n_heads * head_dim, cfg.d_model, qkv_ep),    # Q
        (dense_op, m, cfg.n_kv_heads * head_dim, cfg.d_model, qkv_ep),  # K/V
        (dense_op, m, cfg.d_model, cfg.n_heads * head_dim, "none"),    # O
        (logits_op, m, vocab, cfg.d_model, "none"),                    # logits
    }
    if getattr(cfg, "mlp", "swiglu") == "swiglu":
        if quant:   # the gated layer decomposes into two dense_q GEMMs
            entries.add(("matmul_q", m, cfg.d_ff, cfg.d_model, "none"))
        else:
            entries.add(("gated", m, cfg.d_ff, cfg.d_model, "-"))
        entries.add((dense_op, m, cfg.d_model, cfg.d_ff, "residual"))
    else:  # gelu MLP: bias and gelu fused up, bias fused down
        entries.add((dense_op, m, cfg.d_ff, cfg.d_model, "bias_gelu"))
        entries.add((dense_op, m, cfg.d_model, cfg.d_ff, "bias"))
    if backward:
        fwd = {(mm, nn, kk) for (_, mm, nn, kk, _) in entries}
        entries |= {("matmul", mm, nn, kk, "none")
                    for t in fwd
                    for (mm, nn, kk) in (t, (t[0], t[2], t[1]),
                                         (t[2], t[1], t[0]))}
    return sorted(entries)


def model_gemm_layouts(cfg, batch: int, seq: int, backward: bool = False,
                       quant: bool = False) -> dict:
    """The layouts the port's step runs each of `model_gemm_shapes`'
    entries in: {entry: frozenset of (a_km, b_nk, out dtype name or
    None)}. The forward is row-major but the logits, which come out in
    f32 and, tied, read the [vocab, d] embedding table in place as B's
    transpose view. With backward, `core.gemm`'s cotangent GEMMs: dA =
    g W^T on W's transpose view (the tied logits' on the table itself),
    dW = X^T g on X's, and the recomputed pre-activations of the dual
    GEMM and of the gelu MLP, row-major. One key can run in several
    layouts (a projection's dA shares the key of another's forward); an
    entry the port's step never runs (the reference's recompute of a
    linear flush's GEMM) keeps the row-major layout."""
    m = batch * seq
    head_dim = getattr(cfg, "resolved_head_dim",
                       cfg.head_dim or cfg.d_model // cfg.n_heads)
    vocab = getattr(cfg, "padded_vocab", cfg.vocab)
    qkv_ep = "bias" if getattr(cfg, "qkv_bias", False) else "none"
    dense_op = "matmul_q" if quant else "matmul"
    tied = getattr(cfg, "tie_embeddings", False)
    d, f = cfg.d_model, cfg.d_ff
    # (op, n, k, epilogue, B read in place as [N, K], out dtype, recomputed)
    sites = [(dense_op, cfg.n_heads * head_dim, d, qkv_ep, False, None,
              False),
             (dense_op, cfg.n_kv_heads * head_dim, d, qkv_ep, False, None,
              False),
             (dense_op, d, cfg.n_heads * head_dim, "none", False, None,
              False),
             ("matmul" if tied else dense_op, vocab, d, "none", tied,
              "float32", False)]
    if getattr(cfg, "mlp", "swiglu") == "swiglu":
        sites += [("matmul_q", f, d, "none", False, None, False) if quant
                  else ("gated", f, d, "-", False, None, True),
                  (dense_op, d, f, "residual", False, None, False)]
    else:
        sites += [(dense_op, f, d, "bias_gelu", False, None, True),
                  (dense_op, d, f, "bias", False, None, False)]
    uses = collections.defaultdict(set)
    for op, n, k, ep, b_nk, out, recomputed in sites:
        uses[(op, m, n, k, ep)].add((False, b_nk, out))
        if backward:
            uses[("matmul", m, k, n, "none")].add((False, not b_nk, None))
            uses[("matmul", k, n, m, "none")].add((True, False, None))
            if recomputed:
                uses[("matmul", m, n, k, "none")].add((False, b_nk, None))
    return {e: frozenset(uses.get(e, (ROW_MAJOR,)))
            for e in model_gemm_shapes(cfg, batch, seq, backward=backward,
                                       quant=quant)}


def warm_start(
    cfg,
    batch: int,
    seq,
    *,
    autotune: bool = False,
    backward: bool = False,
    decode_len: int | None = None,
    quant: str = "off",
    cache: TuningCache | None = None,
    device=None,
    iters: int = 10,
    max_candidates: int = 8,
    timer=None,
) -> dict:
    """The launchers' startup hook (launch/serve.py, launch/train.py).

    Checks the tuning cache for the model's GEMM shapes: `seq` may be an
    int or an iterable of sequence lengths (serving warms the admission
    prefill's buckets at batch 1 and the decode rows at batch
    max_slots); backward=True adds the cotangent GEMMs, quant="int8" the
    int8-weight model's GEMMs. The attention and SSD shapes
    (`decode_len`, the KV cache depth, adds the decode attention's) have
    a space of one instance: they are listed under "fixed", never looked
    up or timed. With autotune=False it only reports coverage: a miss
    takes the static plan at run time. With autotune=True the misses are
    tuned on the card (or with `timer`), each in the layouts the step
    runs it in (`model_gemm_layouts`), and the cache is saved before the
    first step. The report: the cache's path and fingerprint, the
    backend tag, the hits, misses, tuned and fixed entries, and each
    tuned entry's TuneResult under "results"."""
    cache = get_cache() if cache is None else cache
    dtype = getattr(cfg, "dtype", "float32")
    seqs = (seq,) if isinstance(seq, int) else tuple(seq)
    quantized = quant == "int8"
    shapes = sorted({s for q in seqs
                     for s in model_gemm_shapes(cfg, batch, q,
                                                backward=backward,
                                                quant=quantized)}
                    | {s for q in seqs
                       for s in model_attention_shapes(
                           cfg, batch, q, backward=backward,
                           decode_len=decode_len)}
                    | set(model_ssd_shapes(cfg, batch)))
    layouts = collections.defaultdict(set)
    for q in seqs:
        for entry, ls in model_gemm_layouts(cfg, batch, q, backward=backward,
                                            quant=quantized).items():
            layouts[entry] |= ls
    kw = dict(cache=cache, device=device, iters=iters, save=False,
              timer=timer, max_candidates=max_candidates)
    hits, misses, tuned, fixed, results = [], [], [], [], []
    for entry in shapes:
        op, m, n, k, ep = entry
        if op in ONE_INSTANCE:
            fixed.append(entry)
            continue
        if op == "gated":
            hit = cache.get_gated(m, n, k, dtype) is not None
        elif op == "matmul_q":
            hit = cache.get_matmul_q(m, n, k, dtype, epilogue=ep) is not None
        else:
            hit = cache.get_matmul(m, n, k, dtype, epilogue=ep) is not None
        if hit:
            hits.append(entry)
        elif autotune:
            if op == "gated":
                res = tune_gated_matmul(m, n, k, dtype, **kw)
            else:
                res = tune_matmul(m, n, k, dtype, epilogue=ep,
                                  quant="int8" if op == "matmul_q" else "off",
                                  layouts=sorted(layouts[entry], key=str),
                                  **kw)
            tuned.append(entry)
            results.append(res)
        else:
            misses.append(entry)
    if tuned:
        cache.save()
    return {
        "path": cache.path,
        "fingerprint": cache.fingerprint,
        "backend": BACKEND,
        "hits": hits,
        "misses": misses,
        "tuned": tuned,
        "fixed": fixed,
        "results": results,
    }


def describe_warm_start(rep: dict) -> str:
    """One-line launcher log for a warm_start report."""
    return (f"tuning cache {rep['path']} [{rep['backend']}]: "
            f"{len(rep['fixed'])} shapes of one instance; "
            f"{len(rep['hits'])} hits, {len(rep['misses'])} misses, "
            f"{len(rep['tuned'])} tuned at startup")
